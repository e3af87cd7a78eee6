"""A traced stretch of the cell's own work under ``torch.profiler``, read into
what the per-layer readers need: the device's busy time as the union of its
operations' intervals, device seconds by kernel class, the kernel count, and
the breakdown the result line carries (the device operations that took most
time, and the idle gaps by the host operation under way in them).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .yardstick import NOT_WORK, kernel_class


def profile(fn):
    """Run ``fn()`` under the profiler, then synchronise; returns the
    summary of ``summarize`` with ``window_s`` the host time of the whole."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type()).rsplit('.', 1)[-1]
        row = (e.name(), e.start_ns(), e.duration_ns())
        if kind == 'CUDA':
            if e.name() not in NOT_WORK:
                device.append(row)
        elif kind == 'CPU':
            host.append(row)
    return summarize(device, host, window_s)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(device, host, window_s: float, top: int = 10, gaps: int = 500) -> dict:
    """``device``/``host``: (name, start ns, duration ns) records."""
    merged = _merge([(s, s + d) for _, s, d in device])
    busy_s = sum(e - s for s, e in merged) / 1e9
    by_class, by_name = {}, {}
    for name, _, d in device:
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + d / 1e9
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + d / 1e9
    kernels = sum(1 for name, _, _ in device if not name.startswith(('Memcpy', 'Memset')))
    holes = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                    for i in range(len(merged) - 1)), reverse=True)[:gaps]
    idle = {}
    if holes and host:
        hs = np.array([s for _, s, _ in host], dtype=np.int64)
        he = hs + np.array([d for _, _, d in host], dtype=np.int64)
        for length, s, e in holes:
            mid = (s + e) // 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = host[inside[np.argmin((he - hs)[inside])]][0] if inside.size \
                else 'no host operation'
            idle[label] = idle.get(label, 0.0) + length / 1e9
    return {'window_s': window_s, 'busy_s': busy_s, 'class_s': by_class, 'kernels': kernels,
            'device_ops': sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            'idle_gaps': sorted(idle.items(), key=lambda kv: -kv[1])[:top]}
