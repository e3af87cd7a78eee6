"""The median host time of one serving forward call in the closed loop,
without a synchronise (ms): the host's dispatch of the request's launches,
the copy of its images to the card among them."""

import numpy as np


def read(rec):
    d = rec['window'].get('dispatch_s')
    if rec['traffic']['loop'] != 'closed' or not d:
        return None
    return float(np.median(np.asarray(d) * 1e3))
