"""The first calibration batch's host seconds in set-up (the program's first
``calib.batch`` span) less the median of the others: what the first forward
pays for loading (libraries, handles, lazily loaded kernels)."""

import numpy as np

from benchmark import span_reads


def read(rec):
    spans = span_reads.setup(rec)
    if spans is None:
        return None
    batches = [span_reads.seconds(s) for s in spans if s.name == 'calib.batch']
    if len(batches) < 2:
        return None
    return batches[0] - float(np.median(batches[1:]))
