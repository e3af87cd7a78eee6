"""Bias and variance correction of quantized tensors.

Port of ``cnn_quantization_tpu/ops/bias_corr.py`` (reference
inference_quantization_manager.py: weights :374-393, activations :180-203).
OIHW weights correct per dim 0; NCHW activations per dim 1.

The weight correction's per-channel means are summed in the order XLA's CPU
backend sums the JAX package's ``jnp.mean`` over an HWIO (or ``[in, out]``)
kernel, then divided by the count, so the corrected weights equal the JAX
package's eager ops bit for bit on any device.  ``torch.mean`` sums in
another order and puts a last-bit difference into most of a trained
kernel's channel means.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8
# XLA's CPU TreeReductionRewriter: a reduction with a reduced dim above this
# size is first summed in windows of this size along every reduced dim
_XLA_WINDOW = 32


def _per_out_channel(x: torch.Tensor, out_axis: int):
    out_axis = out_axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != out_axis)
    shape = [1] * x.ndim
    shape[out_axis] = x.shape[out_axis]
    return dims, shape


def _sequential_sum(x):
    """``x [R, ...]`` summed over dim 0 one row after another, from +0."""
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc


def xla_cpu_sum(x):
    """The sum of ``x [*R, O]`` over its leading dims in the order of XLA's
    CPU backend: row-major, one element after another, when no reduced dim
    exceeds 32; else windows of 32 along every reduced dim (a dim of 32 or
    fewer is one window; a longer one is padded with zeros to a multiple of
    32, half the padding below, half above), each window summed row-major,
    then the windows' sums reduced the same way.  Bit-equal to ``jnp.sum``
    on the CPU where at most one reduced dim exceeds 32, as in every conv
    and linear kernel."""
    *red, o = x.shape
    if all(d <= _XLA_WINDOW for d in red):
        return _sequential_sum(x.reshape(-1, o))
    sizes, windows = [], []
    for axis, d in enumerate(red):
        if d <= _XLA_WINDOW:
            sizes += [1, d]
            windows.append(d)
            continue
        k = math.ceil(d / _XLA_WINDOW)
        pad = k * _XLA_WINDOW - d
        lo = x.new_zeros(x.shape[:axis] + (pad // 2,) + x.shape[axis + 1:])
        hi = x.new_zeros(x.shape[:axis] + (pad - pad // 2,) + x.shape[axis + 1:])
        x = torch.cat([lo, x, hi], dim=axis)
        sizes += [k, _XLA_WINDOW]
        windows.append(_XLA_WINDOW)
    n = len(red)
    x = x.reshape(sizes + [o]).permute([2 * i + 1 for i in range(n)] + [2 * i for i in range(n)]
                                       + [2 * n])
    counts = [sizes[2 * i] for i in range(n)]
    parts = _sequential_sum(x.reshape(math.prod(windows), math.prod(counts), o))
    return xla_cpu_sum(parts.reshape(counts + [o]))


def _jax_layout(w, out_axis: int):
    """The weight as the JAX package holds it, its output channels last:
    OIHW as HWIO, ``[out, in]`` as ``[in, out]``; other ranks with
    ``out_axis`` moved last."""
    out_axis = out_axis % w.ndim
    if w.ndim == 4 and out_axis == 0:
        return w.permute(2, 3, 1, 0)
    return w.movedim(out_axis, -1)


def xla_cpu_channel_mean(w, out_axis: int = 0):
    """The per-output-channel mean of a weight as the JAX package's eager
    ``jnp.mean`` over its kernel computes it on the CPU: ``xla_cpu_sum``
    divided by the count.  (Under ``jit`` XLA multiplies by the count's
    reciprocal instead, which differs in the last bit.)"""
    k = _jax_layout(w, out_axis)
    n = math.prod(k.shape[:-1])
    return xla_cpu_sum(k) / torch.full((), float(n), dtype=torch.float32, device=w.device)


def xla_cpu_channel_std(w, out_axis: int = 0):
    """The per-output-channel ``jnp.std(ddof=1)`` of a weight, eager on the
    CPU: the root of ``xla_cpu_sum`` of the squared deviations from
    ``xla_cpu_channel_mean``, divided by n - 1.  The root is taken in float64
    and rounded once, the correctly rounded float32 root that XLA and CUDA
    give (``torch.sqrt`` of float32 on the CPU is not: about 1 in 130
    results a last bit apart)."""
    k = _jax_layout(w, out_axis)
    n = math.prod(k.shape[:-1])
    centered = k - xla_cpu_channel_mean(w, out_axis)
    var = xla_cpu_sum(centered * centered) / torch.full((), float(n - 1), dtype=torch.float32,
                                                         device=w.device)
    return torch.sqrt(var.double()).float()


def weight_correction(w_orig, w_q, *, out_axis: int = 0,
                      bias_corr: bool = True, var_corr: bool = False):
    """Match the per-output-channel mean (and optionally std) of ``w_q`` to
    ``w_orig``: variance first, then bias, the reference's order
    (inference_quantization_manager.py:380-391).  The means are the JAX
    package's bit for bit (``xla_cpu_channel_mean``, ``xla_cpu_channel_std``)."""
    w_orig = w_orig.float()
    w_q = w_q.float()
    _, shape = _per_out_channel(w_q, out_axis)

    mu_q = xla_cpu_channel_mean(w_q, out_axis).reshape(shape)
    mu_o = xla_cpu_channel_mean(w_orig, out_axis).reshape(shape)

    if var_corr:
        std_o = xla_cpu_channel_std(w_orig, out_axis).reshape(shape)
        std_q = xla_cpu_channel_std(w_q, out_axis).reshape(shape)
        w_q = (w_q - mu_q) * (std_o / (std_q + _EPS)) + mu_q

    if bias_corr:
        w_q = w_q - mu_q + mu_o

    return w_q


def activation_bias_correction(out, out_q, *, channel_axis: int = 1,
                               pre_relu: bool = True):
    """Per-channel positive-part mean correction of a quantized activation
    (inference_quantization_manager.py:188-196): with r = relu(out),
    q_bias_c = (sum_c r - sum_c out_q) / count(r > 0), out_q += [out_q > 0] * q_bias_c.
    """
    out = out.float()
    out_q = out_q.float()
    dims, shape = _per_out_channel(out, channel_axis)

    ref = out.clamp_min(0.0) if pre_relu else out
    q_bias = torch.sum(ref, dim=dims) - torch.sum(out_q, dim=dims)
    count = torch.sum((ref > 0).float(), dim=dims)
    q_bias = (q_bias / (count + _EPS)).reshape(shape)

    return out_q + (out_q > 0).to(out_q.dtype) * q_bias
