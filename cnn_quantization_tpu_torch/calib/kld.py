"""TensorRT-style KLD calibration threshold.

Port of ``cnn_quantization_tpu/calib/kld.py`` (reference
pytorch_quantizer/quantization/inference/kld_threshold.py, NVIDIA's
entropy-calibration sweep): for a symmetric histogram of the activation,
sweep candidate thresholds; for each, form the clipped reference
distribution p (outliers folded into the edge bins) and its 15-bin quantized
reconstruction q; pick the threshold minimizing KL(p || q).

The sweep runs on the host.  The C++ sweep (``native.py``,
``csrc/kld_threshold.cpp``) is the one calibration uses; the numpy body
below is its plain version, reached only with ``use_native=False``.  The
two histogram the same range with different bin arithmetic, so their
thresholds agree within two bins.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from . import capture

_SMOOTH_EPS = 1e-4


def _smooth(p: np.ndarray) -> np.ndarray:
    """Replace zeros with eps, debiting nonzero entries proportionally."""
    is_zero = p == 0
    n_zero = int(is_zero.sum())
    n_nonzero = p.size - n_zero
    if n_nonzero == 0:
        raise ValueError('all-zero distribution')
    out = p.astype(np.float64).copy()
    out[is_zero] += _SMOOTH_EPS
    out[~is_zero] -= _SMOOTH_EPS * n_zero / n_nonzero
    return out


def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    p = p / p.sum()
    q = q / q.sum()
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))


def _kld_threshold_numpy(arr, num_bins: int, num_quantized_bins: int) -> float:
    arr = np.asarray(arr).ravel()
    th = float(max(abs(arr.min()), abs(arr.max())))
    if th == 0.0:
        return 0.0
    hist, edges = np.histogram(arr, bins=num_bins, range=(-th, th))
    zero = num_bins // 2
    half_q = num_quantized_bins // 2

    best_div = np.inf
    best_th = th
    for i in range(half_q, num_bins // 2 + 1):
        lo, hi = zero - i, zero + i + 1
        sliced = hist[lo:hi]
        p = sliced.astype(np.float64).copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        nonzero_mask = sliced != 0

        # quantize sliced into num_quantized_bins merged bins, then expand the
        # merged mass uniformly over the group's originally nonzero bins
        merged = sliced.size // num_quantized_bins
        q = np.zeros_like(p)
        for j in range(num_quantized_bins):
            start = j * merged
            stop = sliced.size if j == num_quantized_bins - 1 else start + merged
            total = sliced[start:stop].sum()
            group_mask = nonzero_mask[start:stop]
            n = int(group_mask.sum())
            if n:
                q[start:stop][group_mask] = total / n
        q[~nonzero_mask] = 0

        try:
            ps = _smooth(p)
            qs = _smooth(q)
        except ValueError:
            continue
        div = _kl_divergence(ps, qs)
        if div < best_div:
            best_div = div
            best_th = edges[hi]
    return float(best_th)


def kld_threshold(arr, num_bins: int = 2001, num_quantized_bins: int = 15,
                  use_native: bool = True) -> float:
    """Optimal symmetric clip threshold of ``arr``'s values by KL-divergence
    sweep: the C++ sweep, or with ``use_native=False`` the numpy one."""
    if use_native:
        return native.kld_threshold_native(arr, num_bins, num_quantized_bins)
    return _kld_threshold_numpy(arr, num_bins, num_quantized_bins)


def kld_threshold_batch(arr2d, num_bins: int = 2001, num_quantized_bins: int = 15,
                        use_native: bool = True) -> np.ndarray:
    """One threshold per row of a [batch, elems] array: the C++ sweep's batch
    entry point, or the numpy sweep row by row."""
    if use_native:
        return native.kld_threshold_batch_native(arr2d, num_bins, num_quantized_bins)
    return np.asarray([_kld_threshold_numpy(row, num_bins, num_quantized_bins)
                       for row in np.asarray(arr2d)], np.float64)


def _image_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [N, ...] as [N, elems] with each image's values in one row.  A
    threshold depends on the set of an image's values, not their order, so a
    channels_last activation is read as its NHWC view, without a copy."""
    if t.ndim == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        t = t.permute(0, 2, 3, 1)
    return t.reshape(t.shape[0], -1)


def acts_to_host(acts: dict) -> dict[str, np.ndarray]:
    """{site: [N, ...] device tensor} -> {site: [N, elems] float32 array}, in
    one device-to-host copy: the sites' rows are gathered into one buffer on
    the device first."""
    sites = list(acts)
    rows = [_image_rows(acts[s].float()) for s in sites]
    flat = torch.cat([r.reshape(-1) for r in rows]).cpu().numpy()
    out, i = {}, 0
    for s, r in zip(sites, rows):
        out[s] = flat[i:i + r.numel()].reshape(r.shape)
        i += r.numel()
    return out


def add_kld_thresholds(summary, engine, params, batches, *,
                       cal_set_size: int | None = None,
                       num_quantized_bins: int = 15, use_native: bool = True):
    """Augment a calibration summary with per-site 'scalar/<kind>_kld_th'.

    As the reference (statistic_manager.py:80-82): per batch, a site's
    threshold is the max over its per-image thresholds; the kinds
    (min/mean/max) aggregate across batches.  ``cal_set_size`` stops after
    that many images."""
    capture_fn = capture.make_capture_fn(engine)
    rows: dict[str, list[float]] = {}
    seen = 0
    for images, _ in batches:
        if cal_set_size is not None and seen >= cal_set_size:
            break
        acts = acts_to_host(capture_fn(params, images))
        for site_id, t in acts.items():
            per_image = kld_threshold_batch(t, num_quantized_bins=num_quantized_bins,
                                            use_native=use_native)
            rows.setdefault(site_id, []).append(float(np.max(per_image)))
        seen += images.shape[0]
    for site_id, vals in rows.items():
        entry = summary.setdefault(site_id, {})
        v = np.asarray(vals, np.float32)
        entry['scalar/min_kld_th'] = v.min()
        entry['scalar/mean_kld_th'] = v.mean()
        entry['scalar/max_kld_th'] = v.max()
    return summary
