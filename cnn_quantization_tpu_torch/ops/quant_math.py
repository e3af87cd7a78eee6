"""Core GEMMLOWP-style affine fake-quantization math (plain PyTorch).

Port of ``cnn_quantization_tpu/ops/quant_math.py``; the semantics are the
reference's ``__gemmlowpQuantize1__`` (int_quantizer.py:557-603) and CUDA
``float2gemmlowp`` (kernels/gemmlowp.cu:8-45):

  * uint grid [0, qmax], qmax = 2**bits - 1 (a per-channel vector under bit
    allocation);
  * scale = delta / qmax (0 where qmax == 0), floored at 1e-8;
  * zero_point = round(-offset / scale); q = round(clamp(x/scale + zp, 0, qmax));
  * dequant (q - zp) * scale.

Rounding is ``torch.round`` (half to even, as ``jnp.round``) and every
division is a true division between tensors: on the card, PyTorch turns a
division by a host scalar into a multiply by its reciprocal, which would move
values across rounding boundaries.  Python numbers therefore enter as
device-side tensors (``utils.device.as_f32``).

These functions are what the hand-written CUDA kernel
(``ops/kernels/fake_quant.py``) is held against; the quantizer dispatch itself
calls the kernel's wrapper.
"""

from __future__ import annotations

import torch

from ..utils.device import as_f32

SCALE_EPS = 1e-8


def _device(*vals) -> torch.device:
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device('cpu')


def qmax_for_bits(bits) -> torch.Tensor:
    """2**bits - 1, elementwise."""
    bits = as_f32(bits, _device(bits))
    return torch.pow(2.0, bits) - 1.0


def affine_qparams(delta, offset, qmax, *, device=None):
    """(scale, zero_point) from range ``delta``, min ``offset`` and ``qmax``
    (int_quantizer.py:557-572; zero is always exactly representable)."""
    dev = device if device is not None else _device(delta, offset, qmax)
    delta, offset, qmax = (as_f32(v, dev) for v in (delta, offset, qmax))
    scale = torch.where(qmax > 0, delta / torch.clamp(qmax, min=1.0), 0.0)
    scale = torch.clamp(scale, min=SCALE_EPS)
    zero_point = torch.round(-offset / scale)
    return scale, zero_point


def _bcast(v: torch.Tensor, ndim: int, channel_axis: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast along ``channel_axis``;
    scalars stay scalars."""
    if v.ndim == 0:
        return v
    shape = [1] * ndim
    shape[channel_axis] = v.shape[0]
    return v.reshape(shape)


def fake_quant(x, delta, offset, qmax, *, channel_axis: int | None = None,
               noise: torch.Tensor | None = None):
    """Quantize->dequantize ``x`` to the affine uint grid.

    ``delta``/``offset``/``qmax`` are scalars (per tensor) or vectors of
    length ``x.shape[channel_axis]`` (per channel); a per-channel ``qmax`` is
    how bit allocation applies.  ``noise`` (uniform in [-0.5, 0.5), shaped
    like ``x``) is stochastic rounding, added before the clamp as in
    gemmlowp.cu:16-18.
    """
    out_dtype = x.dtype
    xf = x.float()
    scale, zero_point = affine_qparams(delta, offset, qmax, device=x.device)
    qmax = as_f32(qmax, x.device)
    if channel_axis is not None:
        scale, zero_point, qmax = (_bcast(v, xf.ndim, channel_axis) for v in
                                   (scale, zero_point, qmax))
    q = xf / scale + zero_point
    if noise is not None:
        q = q + noise
    q = torch.minimum(q.clamp_min(0.0), qmax)
    q = torch.round(q)
    return ((q - zero_point) * scale).to(out_dtype)


def quantize_codes(x, delta, offset, qmax, *, channel_axis: int | None = None):
    """Integer codes (as float32) plus (scale, zero_point)."""
    xf = x.float()
    scale, zero_point = affine_qparams(delta, offset, qmax, device=x.device)
    qmaxf = as_f32(qmax, x.device)
    if channel_axis is not None:
        scale, zero_point, qmaxf = (_bcast(v, xf.ndim, channel_axis) for v in
                                    (scale, zero_point, qmaxf))
    q = torch.round(torch.minimum((xf / scale + zero_point).clamp_min(0.0), qmaxf))
    return q, (scale, zero_point)


def dequantize_codes(q, scale, zero_point, *, channel_axis: int | None = None):
    qf = q.float()
    if channel_axis is not None:
        scale, zero_point = (_bcast(v, qf.ndim, channel_axis) for v in (scale, zero_point))
    return (qf - zero_point) * scale


def fake_quant_kernel_semantics(x, delta, offset, num_bits: int):
    """Per-tensor fake-quant with the reference's native-kernel semantics
    (gemmlowp.cu:30-45, int_quantizer.py:605-614):

      * ``delta <= 0``: the input passes through unchanged;
      * no 1e-8 scale floor;
      * the rounded zero point only when the range straddles zero
        (``offset < 0 < offset + delta``); otherwise the exact affine form
        ``round((x - offset) / scale) * scale + offset``.
    """
    xf = x.float()
    dev = x.device
    delta, offset = as_f32(delta, dev), as_f32(offset, dev)
    qmax = 2.0 ** num_bits - 1.0

    scale = delta / as_f32(qmax, dev)
    safe_scale = torch.where(delta > 0, scale, 1.0)
    zero_point = torch.round(-offset / safe_scale)
    straddles = (offset + delta > 0) & (offset < 0)
    shift = torch.where(straddles, zero_point, -offset)

    q = torch.where(straddles, xf / safe_scale + shift, (xf + shift) / safe_scale)
    # kernel order: min with qmax, max with 0, then round (gemmlowp.cu:17-19)
    q = torch.round(q.clamp(0.0, qmax))
    deq = torch.where(straddles, (q - shift) * safe_scale, q * safe_scale - shift)
    return torch.where(delta > 0, deq, xf).to(x.dtype)


def alpha_to_delta_offset(alpha, max_value, min_value, mean, *,
                          half_range: bool, clip2max: bool = False):
    """Clip value alpha -> (delta, offset) = (range, min)
    (int_quantizer.py:284-300, ``alpha2DeltaOffset``)."""
    dev = _device(alpha, mean, max_value, min_value)
    alpha, mean = as_f32(alpha, dev), as_f32(mean, dev)
    if half_range:
        delta = mean.clamp_min(0.0) + alpha
        if clip2max:
            delta = torch.minimum(delta, as_f32(max_value, dev))
        offset = torch.zeros_like(delta)
    else:
        delta = 2.0 * alpha
        if clip2max:
            delta = torch.minimum(delta, as_f32(max_value, dev) - as_f32(min_value, dev))
        offset = torch.maximum(as_f32(min_value, dev), mean - alpha)
    return delta, offset


def minmax_delta_offset(min_value, max_value, *, half_range: bool):
    """Naive min/max range: delta = max - min, offset = min (0 if half-range)
    (int_quantizer.py:361-379)."""
    dev = _device(min_value, max_value)
    min_value, max_value = as_f32(min_value, dev), as_f32(max_value, dev)
    if half_range:
        min_value = torch.zeros_like(min_value)
    return max_value - min_value, min_value
