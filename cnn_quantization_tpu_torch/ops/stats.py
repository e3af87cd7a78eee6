"""Tensor statistics for calibration and online quantization (plain PyTorch).

Port of ``cnn_quantization_tpu/ops/stats.py`` (reference int_quantizer.py:
507-555, statistic_manager*.py).  Activations are logical NCHW, so
per-channel reductions run over every dim but 1; OIHW weights reduce over
every dim but 0.  All stats are float32; ``std`` is the unbiased (ddof=1)
estimator; ``b`` is the Laplace scale mean(|x - mean(x)|).
"""

from __future__ import annotations

from typing import Sequence

import torch

_ALL_STATS = ('min', 'max', 'mean', 'std', 'b', 'mean_abs', 'kurtosis', 'std_pos')


def _reduce_stats(t: torch.Tensor, stats: Sequence[str], dims) -> dict:
    out = {}
    need_mean = any(s in stats for s in ('mean', 'b', 'kurtosis'))
    mean = torch.mean(t, dim=dims, keepdim=True) if need_mean else None
    for s in stats:
        if s == 'min':
            out[s] = torch.amin(t, dim=dims)
        elif s == 'max':
            out[s] = torch.amax(t, dim=dims)
        elif s == 'mean':
            out[s] = mean.squeeze(dims)
        elif s == 'std':
            out[s] = torch.std(t, dim=dims, correction=1)
        elif s == 'std_pos':
            out[s] = torch.std(t.clamp_min(0.0), dim=dims, correction=1)
        elif s == 'b':
            out[s] = torch.mean(torch.abs(t - mean), dim=dims)
        elif s == 'mean_abs':
            out[s] = torch.mean(torch.abs(t), dim=dims)
        elif s == 'kurtosis':
            std = torch.std(t, dim=dims, correction=1, keepdim=True)
            out[s] = torch.mean(((t - mean) / std) ** 4, dim=dims) - 3.0
        else:
            raise ValueError(f'unknown stat {s!r}')
    return out


def act_stats(x, stats: Sequence[str], *, avg_over_batch: bool = False) -> dict:
    """Per-tensor statistics; ``avg_over_batch`` computes each stat per sample
    (dim 0) and averages over the batch (int_quantizer.py:372, 507-528)."""
    t = x.float()
    if avg_over_batch:
        per_sample = _reduce_stats(t.reshape(t.shape[0], -1), stats, dims=(1,))
        return {k: torch.mean(v, dim=0) for k, v in per_sample.items()}
    return _reduce_stats(t.reshape(-1), stats, dims=(0,))


def act_stats_per_channel(x, stats: Sequence[str], *, channel_axis: int = 1,
                          avg_over_batch: bool = False) -> dict:
    """Per-channel statistics: vectors of length ``x.shape[channel_axis]``.

    ``avg_over_batch=False`` reduces over every other dim (the reference's
    [C, N*H*W] reduction); ``True`` reduces per (sample, channel) and then
    averages over samples (int_quantizer.py:530-555)."""
    t = x.float()
    channel_axis = channel_axis % t.ndim
    if not avg_over_batch:
        dims = tuple(i for i in range(t.ndim) if i != channel_axis)
        return _reduce_stats(t, stats, dims)
    dims = tuple(i for i in range(t.ndim) if i not in (0, channel_axis))
    per_sample = _reduce_stats(t, stats, dims)
    return {k: torch.mean(v, dim=0) for k, v in per_sample.items()}


def weight_stats_per_channel(w, stats: Sequence[str], *, out_axis: int = 0) -> dict:
    """Per-output-channel statistics of an OIHW (or [out, in]) weight."""
    t = w.float()
    out_axis = out_axis % t.ndim
    dims = tuple(i for i in range(t.ndim) if i != out_axis)
    return _reduce_stats(t, stats, dims)
