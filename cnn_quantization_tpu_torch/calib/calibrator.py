"""Offline calibration: collect per-site statistics, aggregate, persist.

Port of ``cnn_quantization_tpu/calib/calibrator.py`` (reference
StatisticManager / StatisticManagerPerChannel).  A collect step emits
per-batch stats dicts of device tensors; this module aggregates
min/mean/max across batches on the host (float64) and saves one ``.npz``
artifact in the JAX package's format, byte for byte:
``{site_id: {"scalar/<kind>_<stat>": scalar, "channel/<kind>_<stat>": [C]}}``
flattened to ``"<site>|<stat>"`` keys.  Stats written by either package load
in the other.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from ..utils import spans

KINDS = ('min', 'mean', 'max')


class StatsAggregator:
    """Running min/mean/max across batch-steps for each (site, stat)."""

    def __init__(self):
        self.count: dict[tuple[str, str], int] = {}
        self.sum: dict[tuple[str, str], np.ndarray] = {}
        self.min: dict[tuple[str, str], np.ndarray] = {}
        self.max: dict[tuple[str, str], np.ndarray] = {}

    def update(self, batch_stats: Mapping[str, Mapping[str, Any]]):
        for site, entry in batch_stats.items():
            for stat, value in entry.items():
                v = np.asarray(value, np.float64)
                key = (site, stat)
                if key not in self.count:
                    self.count[key] = 1
                    self.sum[key] = v.copy()
                    self.min[key] = v.copy()
                    self.max[key] = v.copy()
                else:
                    self.count[key] += 1
                    self.sum[key] += v
                    np.minimum(self.min[key], v, out=self.min[key])
                    np.maximum(self.max[key], v, out=self.max[key])

    def summary(self) -> dict[str, dict[str, np.ndarray]]:
        out: dict[str, dict[str, np.ndarray]] = {}
        for (site, stat), n in self.count.items():
            space, name = stat.split('/', 1)
            entry = out.setdefault(site, {})
            entry[f'{space}/min_{name}'] = self.min[(site, stat)].astype(np.float32)
            entry[f'{space}/mean_{name}'] = (self.sum[(site, stat)] / n).astype(np.float32)
            entry[f'{space}/max_{name}'] = self.max[(site, stat)].astype(np.float32)
        return out


def _to_host(batch_stats) -> dict[str, dict[str, np.ndarray]]:
    """One device-to-host copy per batch: every stat is flattened into a
    single buffer on the device first."""
    keys = [(site, stat) for site, entry in batch_stats.items() for stat in entry]
    if not keys:
        return {}
    vals = [batch_stats[s][k].detach().float().reshape(-1) for s, k in keys]
    flat = torch.cat(vals).cpu().numpy()
    out: dict[str, dict[str, np.ndarray]] = {}
    i = 0
    for (site, stat), v in zip(keys, vals):
        n = v.numel()
        shape = tuple(batch_stats[site][stat].shape)
        out.setdefault(site, {})[stat] = flat[i:i + n].reshape(shape)
        i += n
    return out


def collect_statistics(collect_fn, params, batches: Iterable, *,
                       cal_set_size: int | None = None):
    """Run the collect step over ``batches`` (NHWC images) and aggregate.
    ``cal_set_size`` stops after that many images (inference_sim.py:294-296)."""
    agg = StatsAggregator()
    seen = 0
    with spans.span('calib.collect') as top:
        for images, _ in batches:
            if cal_set_size is not None and seen >= cal_set_size:
                break
            with spans.span('calib.batch'):
                _, batch_stats = collect_fn(params, images)
                agg.update(_to_host(batch_stats))
            seen += images.shape[0]
        top.counts = {'images': seen}
        return agg.summary()


def stats_to_device(stats: Mapping[str, Mapping[str, Any]] | None, device):
    """The stats artifact as float32 tensors on ``device``, made once so the
    use-stats forward never copies from the host."""
    if stats is None:
        return None
    return {site: {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                   for k, v in entry.items()}
            for site, entry in stats.items()}


def save_stats(path: str, summary: Mapping[str, Mapping[str, np.ndarray]]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {f'{site}|{stat}': np.asarray(v)
            for site, entry in summary.items() for stat, v in entry.items()}
    np.savez_compressed(path, **flat)


def load_stats(path: str) -> dict[str, dict[str, np.ndarray]]:
    out: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            site, stat = key.split('|', 1)
            out.setdefault(site, {})[stat] = data[key]
    return out


def default_stats_path(arch: str, *, per_channel: bool, base_dir: str | None = None,
                       suffix: str = '') -> str:
    """The JAX package's default location, so both packages find each
    other's artifacts."""
    base = base_dir or os.path.join(os.path.expanduser('~'), 'mxt-sim-tpu')
    sub = 'statistics/per_channel' if per_channel else 'statistics'
    return os.path.join(base, sub, f'{arch}{suffix}.npz')
