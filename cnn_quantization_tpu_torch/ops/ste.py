"""Gradient attachment: one transform in the forward pass, another on the
incoming gradient, as ``torch.autograd.Function``s.

Port of ``cnn_quantization_tpu/ops/ste.py`` (reference utils/attacher.py
``pytorch_attach(tensor, forward_functor, backward_functor)`` :6-58, the
mechanism behind the training-era QuantizationManager's fprop/bprop
quantizers, quantization_manager.py:60-217).  Dead on the reference's
inference path; here so quantization-aware fine-tuning composes with the PTQ
pipeline (``utils/optim.py``).  ``fake_quant_ste`` runs its forward through
the fake-quant kernel's wrapper (``ops/kernels/fake_quant.py``: the CUDA
kernel for a tensor on the card, its plain version on the CPU); its backward
is the clamp mask in plain PyTorch, as the JAX package's backward is no
kernel either.
"""

from __future__ import annotations

import torch

from ..utils.device import as_f32
from .kernels import fake_quant as fq
from .quant_math import _bcast


class _Attached(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, forward_fn, backward_fn):
        ctx.backward_fn = backward_fn
        return forward_fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.backward_fn(g), None, None


def _identity(t):
    return t.view_as(t)


def attach(forward_fn=None, backward_fn=None):
    """``f(x)`` applying ``forward_fn`` to the input and ``backward_fn`` to the
    incoming gradient (either None = identity); both shape-preserving."""
    fwd, bwd = forward_fn or _identity, backward_fn or _identity
    return lambda x: _Attached.apply(x, fwd, bwd)


def straight_through(quant_fn):
    """Straight-through estimator: ``quant_fn`` forward, identity gradient,
    the standard QAT treatment of the non-differentiable round/clamp."""
    return attach(forward_fn=quant_fn, backward_fn=None)


class _FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, offset, qmax, channel_dim):
        delta, offset = as_f32(delta, x.device), as_f32(offset, x.device)
        ctx.save_for_backward(x, delta, offset)
        ctx.channel_dim = channel_dim
        return fq.fake_quant_fused(x, delta, offset, qmax, channel_dim=channel_dim)

    @staticmethod
    def backward(ctx, g):
        x, delta, offset = ctx.saved_tensors
        return fake_quant_ste_mask(x, delta, offset, ctx.channel_dim) * g, None, None, None, None


def fake_quant_ste_mask(x, delta, offset, channel_dim: int | None = None) -> torch.Tensor:
    """The gradient mask of ``fake_quant_ste``: 1 inside the representable
    range ``[offset, offset + delta]``, 0 outside (per channel along
    ``channel_dim`` when ``delta``/``offset`` are vectors)."""
    delta, offset = as_f32(delta, x.device), as_f32(offset, x.device)
    if channel_dim is not None:
        delta, offset = (_bcast(v, x.ndim, channel_dim % x.ndim) for v in (delta, offset))
    return ((x >= offset) & (x <= offset + delta)).to(x.dtype)


def fake_quant_ste(x, delta, offset, qmax, channel_dim: int | None = None):
    """STE-wrapped gemmlowp fake-quant (``quant_math.fake_quant``): quantize
    forward, pass gradients straight through the rounding; the clamp
    boundary still blocks gradients outside the representable range, the
    standard QAT practice.  ``channel_dim`` makes ``delta``/``offset``/
    ``qmax`` per channel."""
    return _FakeQuantSTE.apply(x, delta, offset, qmax, channel_dim)
