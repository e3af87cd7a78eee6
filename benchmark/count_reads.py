"""The program's counts on its ``engine.forward`` spans (``engine.forward``'s
``counts``, the kernels' counters that moved during the forward, from
``ops.kernels._COUNTERS``) as the counter readers of ``metrics/`` need them.
"""

from __future__ import annotations

import numpy as np

from . import span_reads


def forward_mb(rec, keys) -> float | None:
    """The median, over the window's forwards, of the counts ``keys`` summed,
    in MB (1e6 bytes).  None where no forward of the window carries one of
    them (a program without these counters; a key absent from a forward
    that carries another reads 0), or the window's spans are not held whole."""
    spans = span_reads.window(rec)
    if spans is None:
        return None
    counts = [s.counts or {} for s in spans if s.name == 'engine.forward' and s.end_ns is not None]
    if not any(k in c for c in counts for k in keys):
        return None
    return float(np.median([sum(c.get(k, 0) for k in keys) for c in counts])) / 1e6
