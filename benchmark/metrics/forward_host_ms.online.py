"""The median, over the window's requests of the closed loop, of the host
time of the forward call (the program's ``engine.forward`` span) less its
copy of the images to the card (its ``device.h2d`` child), in ms: the host's
dispatch of the request's launches, read inside the program (the inside twin
of ``dispatch_ms.online``)."""

import numpy as np

from benchmark import span_reads


def read(rec):
    if rec['traffic']['loop'] != 'closed':
        return None
    host = span_reads.forward_host_s(span_reads.window(rec))
    return None if host is None else float(np.median(host) * 1e3)
