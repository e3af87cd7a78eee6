"""Streaming int8 copy with a loop-carried scalar: the wrapper of the
hand-written CUDA kernel, its plain PyTorch version, and the carry between
steps.  The memory-rate probe of the throughput bench is a chain of these.

Replaces the Pallas TPU kernel ``bench.py:_dma_probe._copy_kernel`` (:315-326,
reached by ``pl.pallas_call`` at :331)::

    out[i] = int8(int32(a[i]) + s)                 (two's-complement wrap)
    sum(psums) = sum_i (int32(a[i]) + s)           (before narrowing; int32 wrap)

The kernel is ``csrc/stream_copy.cu``, built with nvcc for sm_90a at first use
and bound with ctypes.  It is bound by memory: every byte read once and
written once.  ``s`` is a one-element int32 tensor on ``a``'s device and is
read there, so a chain of steps never synchronises with the host.  The partial
sums come one int32 per thread block (the TPU kernel's 8-row block per grid
step was Mosaic's sublane rule); only their total is part of the contract, and
the plain version returns it as a single partial.

``stream_copy_carry`` is the step's carry ``rem(sum(psums), 2)`` with JAX's
semantics, which differ from PyTorch's defaults twice: ``jnp.sum`` of int32
stays int32 and wraps where ``torch.sum`` widens to int64 (the wrapped sum has
the same parity but may have the other sign), and ``lax.rem`` truncates (the
sign of the dividend, ``torch.fmod``) where ``torch.remainder`` floors.

For a tensor on the CPU the wrapper runs the plain version; for a CUDA tensor
it launches the kernel or raises.  Its launches are counted in the port's one
store, ``utils/counters.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import counters
from . import build

_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build.build_library('stream_copy')
        lib = ctypes.CDLL(str(path))
        c_ptr, c_i64 = ctypes.c_void_p, ctypes.c_int64
        lib.cnnq_stream_copy_blocks.argtypes = [c_i64]
        lib.cnnq_stream_copy_blocks.restype = c_i64
        lib.cnnq_stream_copy.argtypes = [c_ptr, c_ptr, c_ptr, c_ptr, c_i64, c_ptr]
        lib.cnnq_stream_copy.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(a, s):
    if a.dtype != torch.int8:
        raise TypeError(f'int8 tensor expected, got {a.dtype}')
    if not isinstance(s, torch.Tensor) or s.dtype != torch.int32 or s.numel() != 1:
        raise TypeError('the scalar must be a one-element int32 tensor (it is read on the '
                        'device, never on the host)')
    if s.device != a.device:
        raise ValueError(f'scalar on {s.device}, tensor on {a.device}')


def launch(a, s):
    """One launch of the CUDA kernel on ``a``'s current stream."""
    if a.device.type != 'cuda':
        raise ValueError(f'stream-copy kernel needs a CUDA tensor, got {a.device}')
    _check(a, s)
    if a.numel() == 0:   # nothing to stream: no launch, an empty sum
        return torch.empty_like(a), torch.zeros(1, dtype=torch.int32, device=a.device)
    a = a.contiguous()
    s = s.contiguous()
    lib = _library()
    out = torch.empty_like(a)
    psums = torch.empty((lib.cnnq_stream_copy_blocks(a.numel()),), dtype=torch.int32,
                        device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.cnnq_stream_copy(a.data_ptr(), s.data_ptr(), out.data_ptr(), psums.data_ptr(),
                                  a.numel(), stream)
    if rc != 0:
        raise RuntimeError(f'stream-copy kernel launch failed: CUDA error {rc}')
    counters.add('stream_copy')
    return out, psums


def stream_copy(a, s):
    """``a`` int8 (any shape), ``s`` a one-element int32 tensor on the same
    device -> ``(out, psums)``: ``out = int8(int32(a) + s)`` of ``a``'s shape,
    ``psums`` a 1-D int32 tensor whose wrapped total is ``sum(int32(a) + s)``."""
    if a.device.type == 'cpu':
        return stream_copy_plain(a, s)
    return launch(a, s)



def stream_copy_plain(a, s):
    """The plain PyTorch version of ``stream_copy`` (one partial sum)."""
    _check(a, s)
    blk = a.to(torch.int32) + s.reshape(())
    return blk.to(torch.int8), blk.sum(dtype=torch.int32).reshape(1)


def stream_copy_carry(psums):
    """The next step's scalar, ``lax.rem(jnp.sum(psums), 2)`` as a ``[1]``
    int32 tensor on ``psums``' device: the total narrowed to int32 (wrapping)
    before the truncating remainder."""
    total = psums.sum().to(torch.int32)
    return torch.fmod(total, 2).reshape(1)
