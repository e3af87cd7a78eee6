"""FP32 statistical clippers (port of ``cnn_quantization_tpu/ops/clippers.py``;
reference clipping_manager.py, constructed but never invoked there)."""

from __future__ import annotations

import torch

from ..utils.device import as_f32


def statistical_clip(x, rho: float, *, site_stats=None):
    """Symmetric clamp at rho * (mean_abs + 3 * std); the stats come from the
    calibration artifact when given, else from the tensor."""
    xf = x.float()
    if site_stats is not None:
        mean_abs = as_f32(site_stats['mean_mean_abs'], x.device)
        std = as_f32(site_stats['mean_std'], x.device)
    else:
        mean_abs = torch.mean(torch.abs(xf))
        std = torch.std(xf, correction=1)
    bound = rho * (mean_abs + 3.0 * std)
    return torch.clamp(xf, -bound, bound).to(x.dtype)


def ratio_clip(x, rho: float):
    """Clamp at +/- rho * max|x| (clipping_manager.py:45-62)."""
    xf = x.float()
    bound = rho * torch.amax(torch.abs(xf))
    return torch.clamp(xf, -bound, bound).to(x.dtype)
