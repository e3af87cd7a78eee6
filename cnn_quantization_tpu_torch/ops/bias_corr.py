"""Bias and variance correction of quantized tensors.

Port of ``cnn_quantization_tpu/ops/bias_corr.py`` (reference
inference_quantization_manager.py: weights :374-393, activations :180-203).
OIHW weights correct per dim 0; NCHW activations per dim 1.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _per_out_channel(x: torch.Tensor, out_axis: int):
    out_axis = out_axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != out_axis)
    shape = [1] * x.ndim
    shape[out_axis] = x.shape[out_axis]
    return dims, shape


def weight_correction(w_orig, w_q, *, out_axis: int = 0,
                      bias_corr: bool = True, var_corr: bool = False):
    """Match the per-output-channel mean (and optionally std) of ``w_q`` to
    ``w_orig``: variance first, then bias, the reference's order
    (inference_quantization_manager.py:380-391)."""
    w_orig = w_orig.float()
    w_q = w_q.float()
    dims, shape = _per_out_channel(w_q, out_axis)

    mu_q = torch.mean(w_q, dim=dims).reshape(shape)
    mu_o = torch.mean(w_orig, dim=dims).reshape(shape)

    if var_corr:
        std_o = torch.std(w_orig, dim=dims, correction=1).reshape(shape)
        std_q = torch.std(w_q, dim=dims, correction=1).reshape(shape)
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
