"""Host seconds of the recipe's calibration in set-up, read inside the
program: ``calib.collect`` and ``engine.freeze_qparams`` for the simulation,
``engine.freeze_serving_scales`` for serving.  The inside twin of
``calibration_s.sim``, for serving too."""

from benchmark import span_reads


def read(rec):
    return span_reads.total_s(span_reads.setup(rec), (
        'calib.collect', 'engine.freeze_qparams', 'engine.freeze_serving_scales'))
