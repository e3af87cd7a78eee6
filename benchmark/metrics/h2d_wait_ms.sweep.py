"""The median, over the window's batches of the sweep, of the program's
``device.h2d`` span, in ms: the host blocked in the synchronous copy of a
batch from pinned memory to the card, its wait for the work queued ahead of
it included."""

import numpy as np

from benchmark import span_reads


def read(rec):
    spans = span_reads.window(rec)
    if rec['traffic']['loop'] != 'sweep' or spans is None:
        return None
    copies = [span_reads.seconds(s) for s in spans
              if s.name == 'device.h2d' and s.end_ns is not None]
    return float(np.median(copies) * 1e3) if copies else None
