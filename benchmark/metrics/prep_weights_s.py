"""Host seconds of the recipe's weight pass in set-up, read inside the
program: its ``engine.quantize_params`` span (grids, bit allocation, bias
correction) and, for serving, ``engine.prepare_serving_params`` (the int8
codes).  The inside twin of ``weight_pass_s.sim``, for serving too."""

from benchmark import span_reads


def read(rec):
    return span_reads.total_s(span_reads.setup(rec),
                              ('engine.quantize_params', 'engine.prepare_serving_params'))
