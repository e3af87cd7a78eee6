"""The 95th percentile, over every request of the window, of the host time
from sending a request to its top-5 indices being on the host (ms)."""

import numpy as np


def read(rec):
    lat = rec['window'].get('latency_s')
    if rec['traffic']['loop'] != 'closed' or not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
