"""Mid-tread quantization with real-valued per-channel bin allocation.

Port of ``cnn_quantization_tpu/ops/mid_tread.py`` (reference
int_quantizer.py:147-225).  Unlike the gemmlowp path (uint grid, scale and
zero point), mid-tread quantizes x to round(x / Delta) * Delta with a
per-channel step Delta_i = range_i / omega_i, where omega_i is the (rounded)
real-valued bin count the sigma^(2/3) rule allocates to channel i; the clamp
window is centred on the channel mean (symmetric case) or anchored at zero
(asymmetric, post-ReLU case).

Plain PyTorch: no fake-quant kernel runs on a mid-tread site.  Rounding is
``torch.round`` (half to even, as ``jnp.round``) and every division is
between tensors (``utils.device.as_f32``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import as_f32
from . import aciq, bit_alloc
from .entropy import shannon_entropy

_F32_MAX = torch.finfo(torch.float32).max


class MidTreadResult(NamedTuple):
    values: torch.Tensor   # dequantized tensor, same shape as the input
    codes: torch.Tensor    # integer codes (float32), for rate measurement
    delta: torch.Tensor    # per-row step size


def mid_tread_quantize(t, target_bits, *, clip: bool, sym: bool) -> MidTreadResult:
    """Quantize the rows of a 2-D tensor ``t`` [rows, elems] mid-tread style.
    Rows are channels (per-channel mode) or a single row (per-tensor mode);
    reference int_quantizer.py:185-225 (``mid_tread_quantization``)."""
    t = t.float()
    dev = t.device
    std = torch.std(t, dim=-1, correction=1)
    omega = torch.round(bit_alloc.get_omega(std, torch.pow(2.0, as_f32(target_bits, dev))))

    if clip:
        alpha_mult = aciq.alpha_mult_for_omega(omega, sym=sym)
        mu = torch.mean(t, dim=-1)
        b = torch.mean(torch.abs(t - mu[:, None]), dim=-1)
        rng = 2.0 * alpha_mult * b if sym else mu.clamp_min(0.0) + alpha_mult * b
    else:
        hi = torch.amax(t, dim=-1)
        rng = hi - torch.amin(t, dim=-1) if sym else hi

    # an empty channel (omega == 0) gets the largest finite step, so the
    # division below stays finite and its codes are 0
    live = omega > 0
    delta = torch.where(live, rng / torch.where(live, omega, 1.0), _F32_MAX)
    codes = torch.round(t / delta[:, None])

    if clip:
        mu_q = (mu if sym else mu.clamp_min(0.0)) / delta
        c_max = mu_q + (omega / 2.0 if sym else omega)
        c_min = mu_q - omega / 2.0 if sym else torch.zeros_like(mu_q)
        codes = torch.minimum(codes, c_max[:, None])
        codes = torch.maximum(codes, c_min[:, None])

    return MidTreadResult(values=codes * delta[:, None], codes=codes, delta=delta)


def mid_tread_quantize_tensor(x, target_bits, *, clip: bool, sym: bool,
                              per_channel: bool, channel_axis: int = 1,
                              measure_entropy: bool = False):
    """Shape-preserving wrapper over ``mid_tread_quantize``.  ``per_channel``
    takes ``channel_axis`` as the rows (the reference's C x (N*H*W) view,
    int_quantizer.py:170-183; 1 for NCHW activations, 0 for OIHW weights);
    otherwise one row.  Returns (values in ``x``'s dtype, entropy or None)."""
    xf = x.float()
    if per_channel:
        axis = channel_axis % xf.ndim
        rows = xf.movedim(axis, 0)
        res = mid_tread_quantize(rows.reshape(rows.shape[0], -1), target_bits,
                                 clip=clip, sym=sym)
        values = res.values.reshape(rows.shape).movedim(0, axis)
    else:
        res = mid_tread_quantize(xf.reshape(1, -1), target_bits, clip=clip, sym=sym)
        values = res.values.reshape(xf.shape)
    ent = shannon_entropy(res.codes) if measure_entropy else None
    return values.to(x.dtype), ent
