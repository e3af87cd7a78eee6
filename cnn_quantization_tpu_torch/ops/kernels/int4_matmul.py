"""int4-packed GEMM for W4A4 serving blocks: the wrapper of the hand-written
CUDA kernel, its plain PyTorch version, and the packing helpers.

Replaces the Pallas TPU kernel ``cnn_quantization_tpu/ops/kernels/
int4_matmul.py`` (``int4_matmul`` :229-380; ``pack_int4`` :57-69 and
``unpack_int4`` :72-79 are plain tensor code in both)::

    acc[m, n] = sum_k A[m, k] * B[k, n]                    (int32, exact)
    v   = float(acc) * alpha[n] + beta[n]                  (two rounded ops)
    v   = v + float(unpack(residual)[m, n]) * res_scale    (with a residual)
    v   = max(v, 0)                                        (fuse_relu)
    out = v as float32 / bfloat16                          'f32' | 'bf16'
        | int8(clip(round(v / out_scale), +-out_qmax))     'int8'
        | pack(clip(round(v / out_scale), +-7))            'packed'

Activations, the residual identity and the output may hold two 4-bit codes to
a byte, so block boundaries of the W4A4 serving trunk cross device memory at
half a byte a value.  Packing is "group-local split-half": channels go in
groups of ``GROUP`` = 256; within group g, byte ``g*128 + j`` holds code
``g*256 + j`` in its low nibble and code ``g*256 + 128 + j`` in its high
nibble, sign extended on unpack.

The kernel is ``csrc/int4_gemm.cu``, built with nvcc for sm_90a at first use
and bound with ctypes.  On the serving path every shape is bounded by the
bytes it moves.  Nibbles become int8 before the product (the tensor cores
have no 4-bit integer type).  Two routes, chosen by ``int4_route`` from the
operands, never by error (a failure on either raises):

* ``'wgmma'`` where TMA can describe every operand (packed A, or unpacked A
  with K % 16 == 0; every base 16-byte aligned): the persistent TMA +
  ``wgmma`` kernel of ``csrc/int8_wgmma.cuh``, 128 x 64 tiles.  Packed A is
  loaded once, one 128-byte box per packing-group row, and unpacked in shared
  memory; with a residual or a packed output a tile's columns are 32 codes of
  a packing group's low half and the 32 codes 128 further, so both nibbles
  of a byte meet in one thread of the accumulator; byte outputs leave through
  TMA stores.  The epilogue's true division per code bounds the serving
  shapes;
* ``'mma_sync'`` for the rest: the block product of ``csrc/int8_mma.cuh``
  with an unpacking loader, and with a residual or a packed output the
  block's columns renumbered so that a thread's two neighbouring sums are the
  nibbles of one byte; ragged M is masked, nothing is padded in memory.

The TPU version's row pairing and single-step body are devices of its matrix
unit and have no counterpart here.  ``res_scale`` and ``out_scale`` stay on the device (the
kernel reads them through pointers): a host copy would synchronise each of
the 36 launches of a forward.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises.  Its launches by route are counted in the
port's one store, ``utils/counters.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import counters
from ...utils.device import as_f32
from . import build
from .int_matmul import column_vector, int_matmul_exact

GROUP = 256          # channels per packing group
HALF = GROUP // 2    # bytes per group

_MODES = {'f32': 0, 'bf16': 1, 'int8': 2, 'packed': 3}
_LAUNCHES = {'wgmma': 'int4_gemm.wgmma', 'mma_sync': 'int4_gemm.mma_sync'}
_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build.build_library('int4_gemm')
        lib = ctypes.CDLL(str(path))
        c_ptr, c_i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.cnnq_int4_gemm.argtypes = [c_ptr] * 8 + [c_i64] * 3 + [c_int] * 3 + [
            ctypes.c_float, c_int, c_ptr]
        lib.cnnq_int4_gemm.restype = c_int
        _lib = lib
    return _lib


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[..., C] int8 codes holding int4 values -> [..., C/2] packed bytes in
    the group-local split-half layout; C must be a multiple of ``GROUP``."""
    c = codes.shape[-1]
    if c % GROUP:
        raise ValueError(f'channels {c} not a multiple of {GROUP}')
    g = codes.to(torch.int8).reshape(*codes.shape[:-1], c // GROUP, 2, HALF).to(torch.int16)
    byte = (g[..., 0, :] & 0xF) | ((g[..., 1, :] & 0xF) << 4)   # 0 .. 255
    return byte.to(torch.uint8).view(torch.int8).reshape(*codes.shape[:-1], c // 2)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: each nibble sign extended to an int8 code."""
    c2 = packed.shape[-1]
    if c2 % HALF:
        raise ValueError(f'{c2} packed bytes are not whole groups of {HALF}')
    g = packed.reshape(*packed.shape[:-1], c2 // HALF, HALF)
    lo = ((g & 0xF) ^ 8) - 8   # the low nibble's two's complement value
    hi = g >> 4                # arithmetic shift: the high nibble, sign extended
    return torch.stack([lo, hi], dim=-2).reshape(*packed.shape[:-1], c2 * 2)


def int4_route(k: int, a_packed: bool, aligned: bool = True) -> str:
    """The kernel route of an int4 GEMM with depth ``k`` (in codes):
    ``'wgmma'`` where TMA can describe every operand (packed A with k % 256
    == 0, or unpacked A with k % 16 == 0; ``aligned``: every base 16-byte
    aligned), else ``'mma_sync'``.  ``csrc/int4_gemm.cu`` checks the same
    condition."""
    return 'wgmma' if k % (GROUP if a_packed else 16) == 0 and aligned else 'mma_sync'


def _check(a, b, residual, res_scale, out_scale, a_packed, out_mode, out_dtype):
    """Shapes and types both versions take; returns (M, K, N, output dtype)."""
    if out_mode not in _MODES:
        raise ValueError(f"out_mode must be one of {sorted(_MODES)}, got {out_mode!r}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f'int8 operands expected, got {a.dtype} and {b.dtype}')
    if a.ndim != 2 or b.ndim != 2 or b.shape[0] == 0:
        raise ValueError(f'cannot multiply {tuple(a.shape)} by {tuple(b.shape)}')
    (m, ka), (k, n) = a.shape, b.shape
    if a_packed:
        if k % GROUP or ka != k // 2:
            raise ValueError(f'packed A needs K a multiple of {GROUP} and [M, K/2] bytes, got '
                             f'{tuple(a.shape)} for K={k}')
    elif ka != k:
        raise ValueError(f'cannot multiply {tuple(a.shape)} by {tuple(b.shape)}')
    if (residual is not None or out_mode == 'packed') and n % GROUP:
        raise ValueError(f'N={n} needs group alignment ({GROUP}) for a residual or a '
                         'packed output')
    if residual is not None:
        if residual.dtype != torch.int8 or tuple(residual.shape) != (m, n // 2):
            raise ValueError(f'residual must be [{m}, {n // 2}] packed int8 bytes, got '
                             f'{residual.dtype} {tuple(residual.shape)}')
        if res_scale is None:
            raise ValueError('a residual needs res_scale')
    if out_mode in ('int8', 'packed'):
        if out_scale is None:
            raise ValueError(f"out_mode={out_mode!r} needs out_scale")
        return m, k, n, torch.int8
    dtype = torch.bfloat16 if out_mode == 'bf16' else out_dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'int4 GEMM writes float32 or bfloat16, got {dtype}')
    return m, k, n, dtype


def _scalar(v, device):
    s = as_f32(v, device)
    if s.numel() != 1:
        raise ValueError(f'a per-tensor scale expected, got shape {tuple(s.shape)}')
    return s.reshape(())


def launch(a, b, alpha, beta, residual, res_scale, out_scale, a_packed, fuse_relu, out_mode,
           out_qmax, out_dtype, route=None):
    """One launch of the CUDA kernel on ``a``'s current stream.  ``route``
    None takes ``int4_route``'s; ``'mma_sync'``, which takes every call, may
    be asked for to measure it beside that route."""
    if a.device.type != 'cuda' or b.device != a.device:
        raise ValueError(f'int4 GEMM kernel needs CUDA tensors on one device, got '
                         f'{a.device} and {b.device}')
    m, k, n, dtype = _check(a, b, residual, res_scale, out_scale, a_packed, out_mode, out_dtype)
    dev = a.device
    a = a.contiguous()
    bt = b.t().contiguous()  # no copy for a transposed view of an [N, K] weight
    alpha = column_vector(alpha, n, dev)
    beta = None if beta is None else column_vector(beta, n, dev)
    res = rs = osc = None
    if residual is not None:
        if residual.device != dev:
            raise ValueError(f'residual on {residual.device}, operands on {dev}')
        res, rs = residual.contiguous(), _scalar(res_scale, dev)
    if out_mode in ('int8', 'packed'):
        osc = _scalar(out_scale, dev)
    mode = _MODES[out_mode]
    if out_mode == 'f32' and dtype == torch.bfloat16:
        mode = _MODES['bf16']
    out = torch.empty((m, n // 2 if out_mode == 'packed' else n), dtype=dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    own = int4_route(k, a_packed, all(t.data_ptr() % 16 == 0 for t in (a, bt, out)
                                      + (() if res is None else (res,))))
    route = own if route is None else route
    if route not in (own, 'mma_sync'):
        raise ValueError(f'the {route} route cannot take this call; its route is {own}')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().cnnq_int4_gemm(
            a.data_ptr(), bt.data_ptr(), out.data_ptr(), alpha.data_ptr(), ptr(beta), ptr(res),
            ptr(rs), ptr(osc), m, n, k, int(a_packed), int(fuse_relu), mode, float(out_qmax),
            int(route == 'wgmma'), stream)
    if rc != 0:
        raise RuntimeError(f'int4 GEMM kernel launch failed ({route} route): CUDA error {rc}')
    counters.add(_LAUNCHES[route])
    return out


def int4_matmul(a, b, alpha, beta=None, *, residual=None, res_scale=None, out_scale=None,
                a_packed: bool = False, fuse_relu: bool = False, out_mode: str = 'f32',
                out_qmax: float = 127.0, out_dtype=torch.float32):
    """Packed-int4 GEMM with a fused dequant / residual / requant epilogue.

    a        [M, K/2] packed bytes if ``a_packed`` else [M, K] int8 codes.
    b        [K, N] int8 codes (int4 values for W4); the transposed view of
             an [N, K] weight costs no copy.
    alpha    [N] float32: activation scale * per-channel weight scale.
    beta     [N] float32 bias, or None.
    residual [M, N/2] packed bytes (optional), added as
             ``unpack(residual) * res_scale`` before the ReLU.
    out_mode 'f32' (``out_dtype``: float32 or bfloat16), 'bf16', 'int8'
             (codes at ``out_scale``, clipped to +-``out_qmax``), 'packed'
             ([M, N/2] packed codes at ``out_scale``, clipped to +-7).

    ``res_scale`` and ``out_scale`` are per-tensor scales (numbers or 0-dim
    tensors; device tensors are used where they lie).  K must be a multiple of
    256 when ``a_packed``; N a multiple of 256 with a residual or a packed
    output."""
    if a.device.type == 'cpu':
        return int4_matmul_plain(a, b, alpha, beta, residual=residual, res_scale=res_scale,
                                 out_scale=out_scale, a_packed=a_packed, fuse_relu=fuse_relu,
                                 out_mode=out_mode, out_qmax=out_qmax, out_dtype=out_dtype)
    return launch(a, b, alpha, beta, residual, res_scale, out_scale, a_packed, fuse_relu,
                  out_mode, out_qmax, out_dtype)



def int4_matmul_plain(a, b, alpha, beta=None, *, residual=None, res_scale=None, out_scale=None,
                      a_packed: bool = False, fuse_relu: bool = False, out_mode: str = 'f32',
                      out_qmax: float = 127.0, out_dtype=torch.float32):
    """The plain PyTorch version of ``int4_matmul``: unpack, the exact int32
    product, then the epilogue as separate float32 operations in the kernel's
    order (every divisor a device tensor: true division), then pack."""
    _, _, n, dtype = _check(a, b, residual, res_scale, out_scale, a_packed, out_mode, out_dtype)
    dev = a.device
    alpha = column_vector(alpha, n, dev)
    acc = int_matmul_exact(unpack_int4(a) if a_packed else a, b)
    v = acc.float() * alpha.view(1, -1)
    if beta is not None:
        v = v + column_vector(beta, n, dev).view(1, -1)
    if residual is not None:
        v = v + unpack_int4(residual).float() * _scalar(res_scale, dev)
    if fuse_relu:
        v = torch.relu(v)
    if out_mode in ('f32', 'bf16'):
        return v.to(dtype)
    qmax = 7.0 if out_mode == 'packed' else float(out_qmax)
    codes = torch.clamp(torch.round(v / _scalar(out_scale, dev)), -qmax, qmax).to(torch.int8)
    return pack_int4(codes) if out_mode == 'packed' else codes
