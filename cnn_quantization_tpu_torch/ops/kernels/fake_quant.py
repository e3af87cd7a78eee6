"""Fused affine fake-quant: the wrapper of the hand-written CUDA kernel and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``cnn_quantization_tpu/ops/kernels/
fake_quant.py`` (``_fake_quant_2d`` :63-105 with ``_kernel`` :29-37 and
``_kernel_stochastic`` :40-56; host entry ``fake_quant_fused`` :108-144).
The kernel is ``csrc/fake_quant.cu``, built with nvcc for sm_90a at first use
and bound with ctypes.  It is bound by memory: one read and one write per
element, (in bytes + out bytes) x numel at 3.35 TB/s on an H100 SXM.  A
grid-stride loop with four independent loads in flight per thread; the
arithmetic is kept bit-identical to the plain version (see the source).

In JAX, XLA fuses the deterministic fake-quant into the producing conv, so
the Pallas kernel runs only for stochastic rounding.  Eager PyTorch has no
such fusion, so in the port this kernel runs at every quantization site:
weights, activations, frozen and dynamic, in three modes:

  * ``fake_quant_fused``: affine (a), or stochastic (b) with ``stochastic=True``;
  * ``fake_quant_kernel_semantics_fused``: the reference-CUDA per-tensor
    semantics of ``quant_math.fake_quant_kernel_semantics`` (c).

For a tensor on the CPU each wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises.  ``fake_quant_fused.launches``
counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...utils.device import as_f32
from ..quant_math import affine_qparams, fake_quant, fake_quant_kernel_semantics
from . import build

AFFINE, STOCHASTIC, MINMAX = 0, 1, 2  # kernel modes (a), (b), (c)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build.build_library('fake_quant')
        lib = ctypes.CDLL(str(path))
        c_ptr, c_i64 = ctypes.c_void_p, ctypes.c_int64
        lib.cnnq_fake_quant.argtypes = [
            c_ptr, c_ptr, c_i64, c_i64, c_i64, c_ptr, c_ptr, c_ptr, c_i64, c_i64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, c_ptr]
        lib.cnnq_fake_quant.restype = ctypes.c_int
        _lib = lib
    return _lib


def memory_layout(x: torch.Tensor, channel_dim: int | None) -> tuple[int, int]:
    """(C, inner) of ``x`` in memory order seen as [outer, C, inner].

    Row-major tensors (OIHW weights, [N, rest] rows) take C and inner from
    their shape; a 4-D channels_last tensor with ``channel_dim=1`` stores
    channels innermost (inner = 1)."""
    if channel_dim is None:
        return 1, 1
    d = channel_dim % x.ndim
    if x.is_contiguous():
        return x.shape[d], math.prod(x.shape[d + 1:])
    if x.ndim == 4 and d == 1 and x.is_contiguous(memory_format=torch.channels_last):
        return x.shape[1], 1
    raise ValueError(f'fake-quant kernel takes a contiguous or channels_last '
                     f'tensor, got strides {x.stride()} for shape {tuple(x.shape)}')


def launch(x, p0, p1, qmax, channel_dim, mode, seed=0):
    """One launch of the CUDA kernel on ``x``'s current stream; returns the
    output (same shape, dtype and strides as ``x``).  ``p0``/``p1`` are the
    scale and zero point in modes AFFINE/STOCHASTIC and delta/offset in mode
    MINMAX; each parameter holds one value or one per channel."""
    if x.device.type != 'cuda':
        raise ValueError(f'fake-quant kernel needs a CUDA tensor, got {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'fake-quant kernel takes float32 or bfloat16, got {x.dtype}')
    channels, inner = memory_layout(x, channel_dim)
    p0, p1, qmax = (v.to(device=x.device, dtype=torch.float32).contiguous()
                    for v in (p0, p1, qmax))
    if p0.numel() != p1.numel() or p0.numel() not in (1, channels) \
            or qmax.numel() not in (1, channels):
        raise ValueError(f'parameters must hold 1 or {channels} values, got '
                         f'{p0.numel()}, {p1.numel()} and {qmax.numel()}')
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().cnnq_fake_quant(
            x.data_ptr(), out.data_ptr(), x.numel(), channels, inner,
            p0.data_ptr(), p1.data_ptr(), qmax.data_ptr(),
            int(p0.numel() > 1), int(qmax.numel() > 1), mode, _DTYPES[x.dtype],
            seed & 0xFFFFFFFFFFFFFFFF, stream)
    if rc != 0:
        raise RuntimeError(f'fake-quant kernel launch failed: CUDA error {rc}')
    fake_quant_fused.launches += 1
    return out


def fake_quant_fused(x, delta, offset, qmax, *, channel_dim: int | None = None,
                     stochastic: bool = False, seed: int = 0):
    """Modes (a) and (b): the affine fake-quant of ``quant_math.fake_quant``,
    with ``stochastic=True`` adding Philox noise keyed by (seed, element)
    before the clamp.  ``channel_dim`` names the dim that per-channel
    ``delta``/``offset``/``qmax`` index (1 for NCHW activations, 0 for OIHW
    weights); scalars broadcast."""
    if x.device.type == 'cpu':
        return fake_quant_fused_plain(x, delta, offset, qmax, channel_dim=channel_dim,
                                      stochastic=stochastic, seed=seed)
    scale, zero_point = torch.broadcast_tensors(
        *affine_qparams(delta, offset, qmax, device=x.device))
    return launch(x, scale, zero_point, as_f32(qmax, x.device), channel_dim,
                  STOCHASTIC if stochastic else AFFINE, seed)


fake_quant_fused.launches = 0


def fake_quant_kernel_semantics_fused(x, delta, offset, num_bits: int):
    """Mode (c): per-tensor ``delta``/``offset`` with the reference-CUDA
    semantics (pass-through when delta <= 0, no scale floor, rounded zero
    point only when the range straddles 0)."""
    if x.device.type == 'cpu':
        return fake_quant_kernel_semantics(x, delta, offset, num_bits)
    return launch(x, as_f32(delta, x.device), as_f32(offset, x.device),
                  as_f32(2.0 ** num_bits - 1.0, x.device), None, MINMAX)


def fake_quant_fused_plain(x, delta, offset, qmax, *, channel_dim: int | None = None,
                           stochastic: bool = False, seed: int = 0):
    """The plain PyTorch version of modes (a)/(b).  The stochastic noise comes
    from a ``torch.Generator`` seeded with ``seed``: the same distribution as
    the kernel's Philox bits, not the same numbers."""
    noise = None
    if stochastic:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        noise = torch.rand(x.shape, generator=gen, device=x.device,
                           dtype=torch.float32) - 0.5
    return fake_quant(x, delta, offset, qmax, channel_axis=channel_dim, noise=noise)


# the plain version of mode (c)
fake_quant_kernel_semantics_plain = fake_quant_kernel_semantics
