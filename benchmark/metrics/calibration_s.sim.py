"""Host seconds of the simulation recipe's calibration in the timed
preparation: the statistics of the calibration images
(``collect_statistics``) and ``freeze_qparams``, ending in a synchronise."""


def read(rec):
    return rec['prep']['calibration_s'] if rec['traffic']['path'] == 'sim' else None
