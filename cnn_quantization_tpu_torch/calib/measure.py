"""Runtime activation measurement (the reference's -ms mode).

Port of ``cnn_quantization_tpu/calib/measure.py`` (reference
pytorch_quantizer/quantization/inference/distance_stats.py and
measure_statistics.py): run the float and the quantized forward on the same
batch and compare each site's tensors.  The comparison runs on the device in
float64; only each site's five numbers go to the host, once per batch.  The
CSV is written with the standard library, in the layout of the JAX
package's pandas CSV (sites as rows, an unnamed index column).
"""

from __future__ import annotations

import csv
import os
from typing import Iterable

import numpy as np
import torch

from ..utils.device import nhwc_to_nchw

COLUMNS = ('norm_fp', 'norm_q', 'mse', 'cos', 'rel_err')


def _distances(f: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[norm_fp, norm_q, mse, cos, rel_err] of two tensors, in float64."""
    f = f.double().reshape(-1)
    q = q.double().reshape(-1)
    nf, nq = torch.linalg.norm(f), torch.linalg.norm(q)
    d = f - q
    return torch.stack([nf, nq, torch.mean(d * d), torch.dot(f, q) / (nf * nq + 1e-12),
                        torch.linalg.norm(d) / (nf + 1e-12)])


def measure_statistics(engine, params_fp, params_q, batches: Iterable, *,
                       stats=None, max_batches: int = 4) -> dict[str, list[dict]]:
    """Per-site rows of {norm_fp, norm_q, mse, cos, rel_err}, one row a
    batch, comparing the float model against the quantized one (the policy
    applied with ``stats``, dynamically) on the same inputs."""
    from ..calib.calibrator import stats_to_device
    from ..engine.context import QuantizeContext
    from .capture import CaptureContext

    class CapturingQC(QuantizeContext):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.outs = {}

        def tap(self, x, site):
            out = super().tap(x, site)
            self.outs[site.id] = out
            return out

    device = engine.device
    stats = stats_to_device(stats, device)
    rows: dict[str, list[dict]] = {}
    for i, (images, _) in enumerate(batches):
        if i >= max_batches:
            break
        x = nhwc_to_nchw(images, device)
        with torch.no_grad():
            ctx_f = CaptureContext()
            torch.func.functional_call(engine.model, params_fp, (x, ctx_f))
            ctx_q = CapturingQC(engine.policy, stats=stats, ignore_ids=engine.ignore_ids)
            torch.func.functional_call(engine.model, params_q, (x, ctx_q))
            sites = [s for s in ctx_f.captured if s in ctx_q.outs]
            if not sites:
                continue
            table = torch.stack([_distances(ctx_f.captured[s], ctx_q.outs[s])
                                 for s in sites]).cpu().numpy()
        for site, vals in zip(sites, table):
            rows.setdefault(site, []).append(dict(zip(COLUMNS, map(float, vals))))
    return rows


def save_measure_csv(frames: dict, folder: str, arch: str) -> str:
    """``<folder>/<arch>_distance.csv``: one row a site, in site-id order as the
    JAX package writes them, each column the mean over batches."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f'{arch}_distance.csv')
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow([''] + list(COLUMNS))
        for site in sorted(frames):
            rows = frames[site]
            w.writerow([site] + [repr(float(np.mean([r[c] for r in rows]))) for c in COLUMNS])
    return path
