"""Tensor statistics for calibration and online quantization (plain PyTorch).

Port of ``cnn_quantization_tpu/ops/stats.py`` (reference int_quantizer.py:
507-555, statistic_manager*.py).  Activations are logical NCHW, so
per-channel reductions run over every dim but 1; OIHW weights reduce over
every dim but 0.  All stats are float32; ``std`` is the unbiased (ddof=1)
estimator; ``b`` is the Laplace scale mean(|x - mean(x)|).

Under data parallelism each rank holds a slice of the batch, and an
activation statistic must be the whole batch's, as GSPMD makes it in the JAX
package.  A forward run inside ``global_over(group)`` (the data group the
tap context carries, ``engine/engine.py``) reduces every activation
statistic over that group: min and max by MIN/MAX all-reduce, the mean as a
sum of sums over the global count, ``std``, ``b``, ``kurtosis`` and
``std_pos`` in a second pass around the global mean, and a batch average as
the sum of per-sample values over the global batch.  Weight statistics never
reduce over ranks.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Sequence

import torch
import torch.distributed as dist

_ALL_STATS = ('min', 'max', 'mean', 'std', 'b', 'mean_abs', 'kurtosis', 'std_pos')

_DATA_GROUP = contextvars.ContextVar('data_group', default=None)


@contextlib.contextmanager
def global_over(group):
    """Activation statistics inside reduce over ``group`` (None: local)."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def data_group():
    """The group activation statistics reduce over, or None."""
    return _DATA_GROUP.get()


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def global_sum(t: torch.Tensor, dims=None) -> torch.Tensor:
    """The sum of ``t`` over ``dims`` (all dims by default), summed over the
    data group when a forward runs inside ``global_over``."""
    s = torch.sum(t) if dims is None else torch.sum(t, dim=dims)
    group = data_group()
    return s if group is None else _all_reduce(s, group)


def _reduce_stats_global(t: torch.Tensor, stats: Sequence[str], dims, group) -> dict:
    """``_reduce_stats`` of the concatenation of every rank's ``t`` along
    the reduced dims (the batch among them); every rank holds an equal
    slice (``parallel.mesh.shard_batch``)."""
    count = float(math.prod(t.shape[d] for d in dims) * dist.get_world_size(group))

    def gsum(v):
        return _all_reduce(torch.sum(v, dim=dims, keepdim=True), group)

    def gmean(v):
        return gsum(v) / count

    def gstd(v, mean):
        return torch.sqrt(gsum((v - mean) ** 2) / (count - 1.0))

    out = {}
    mean = gmean(t) if any(s in stats for s in ('mean', 'std', 'b', 'kurtosis')) else None
    for s in stats:
        if s == 'min':
            out[s] = _all_reduce(torch.amin(t, dim=dims), group, dist.ReduceOp.MIN)
        elif s == 'max':
            out[s] = _all_reduce(torch.amax(t, dim=dims), group, dist.ReduceOp.MAX)
        elif s == 'mean':
            out[s] = mean.squeeze(dims)
        elif s == 'std':
            out[s] = gstd(t, mean).squeeze(dims)
        elif s == 'std_pos':
            pos = t.clamp_min(0.0)
            out[s] = gstd(pos, gmean(pos)).squeeze(dims)
        elif s == 'b':
            out[s] = gmean(torch.abs(t - mean)).squeeze(dims)
        elif s == 'mean_abs':
            out[s] = gmean(torch.abs(t)).squeeze(dims)
        elif s == 'kurtosis':
            out[s] = (gmean(((t - mean) / gstd(t, mean)) ** 4) - 3.0).squeeze(dims)
        else:
            raise ValueError(f'unknown stat {s!r}')
    return out


def _batch_mean(per_sample: dict, n_local: int) -> dict:
    """The mean over the batch of per-sample statistics (dim 0), the global
    batch's under ``global_over``."""
    group = data_group()
    if group is None:
        return {k: torch.mean(v, dim=0) for k, v in per_sample.items()}
    count = float(n_local * dist.get_world_size(group))
    return {k: _all_reduce(torch.sum(v, dim=0), group) / count for k, v in per_sample.items()}


def _reduce_stats(t: torch.Tensor, stats: Sequence[str], dims, group=None) -> dict:
    if group is not None:
        return _reduce_stats_global(t, stats, dims, group)
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
        return _batch_mean(per_sample, t.shape[0])
    return _reduce_stats(t.reshape(-1), stats, dims=(0,), group=data_group())


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
        return _reduce_stats(t, stats, dims, group=data_group())
    dims = tuple(i for i in range(t.ndim) if i not in (0, channel_axis))
    per_sample = _reduce_stats(t, stats, dims)
    return _batch_mean(per_sample, t.shape[0])


def weight_stats_per_channel(w, stats: Sequence[str], *, out_axis: int = 0) -> dict:
    """Per-output-channel statistics of an OIHW (or [out, in]) weight."""
    t = w.float()
    out_axis = out_axis % t.ndim
    dims = tuple(i for i in range(t.ndim) if i != out_axis)
    return _reduce_stats(t, stats, dims)
