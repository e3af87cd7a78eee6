"""int8 x int8 -> int32 matrix product with a fused dequant epilogue: the
wrapper of the hand-written CUDA kernel, its plain PyTorch version, and the
symmetric quantizer that makes the codes.

Replaces the Pallas TPU kernel ``cnn_quantization_tpu/ops/kernels/
int_matmul.py`` (``int8_matmul_dequant`` :58-101, body ``_matmul_kernel``
:29-46; ``quantize_sym_int8`` :104-120 is plain tensor code in both)::

    C[m, n]   = sum_k A_q[m, k] * B_q[k, n]        (int32, exact)
    out[m, n] = C[m, n] * alpha[n] + beta[n]       (float32, then optional
                                                    ReLU, then the cast)

The epilogue can also take a residual in (int8 codes in the output's layout
and their scale, added before the ReLU) and hand codes out (the value's int8
codes at the next layer's frozen scale, ``quantize_sym_codes`` fused), so a
serving block passes codes from kernel to kernel; ``fused_epilogue`` is the
plain composition both kernels are held to.

The kernel is ``csrc/int8_gemm.cu``, built with nvcc for sm_90a at first use
and bound with ctypes.  On the true-int8 serving path it carries every 1x1
stride-1 convolution and the classifier.  What bounds it depends on the shape:
a 1x1 conv of an early ResNet stage writes a float32 row for every int8 row it
reads, so memory bounds it; a late stage with K in the thousands is bounded by
the int8 tensor-core rate.  Both operands want K contiguous, which is how the
serving path holds them: an int8 NCHW activation in channels_last memory is a
row-major ``[N*H*W, C]`` matrix, and a 1x1 OIHW weight or an ``[out, in]``
linear weight is ``B`` transposed; the wrapper takes ``b_q`` as such a
transposed view without copying.

Two routes, chosen by ``gemm_route`` from the shape and the operands'
alignment, never by error (a failure on either raises):

* ``'wgmma'`` (``csrc/int8_wgmma.cuh``), where the Tensor Memory Accelerator
  can describe both operands (K % 16 == 0, 16-byte aligned bases): a
  persistent TMA + ``wgmma`` pipeline, 128 x 64/128/256 tiles picked per
  shape, ragged edges zero-filled by TMA;
* ``'mma_sync'`` (``csrc/int8_mma.cuh``) for the rest, e.g. MobileNet-v2's
  K = 24: 128 x 64 tiles of ``mma.sync.m16n8k32.s8``, ragged M, N and K
  masked.

The float hand-off, ``quantize_sym_codes``, launches the codes kernel of
``csrc/fake_quant.cu``; its plain twin is ``quantize_sym_codes_plain``.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises.  Its launches by route, its calls that emit
codes or add a residual, and the codes kernel's launches are counted in the
port's one store, ``utils/counters.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import counters
from ...utils.device import as_f32
from . import build, fake_quant

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_LAUNCHES = {'wgmma': 'int8_gemm.wgmma', 'mma_sync': 'int8_gemm.mma_sync'}


def _library():
    global _lib
    if _lib is None:
        path, _ = build.build_library('int8_gemm')
        lib = ctypes.CDLL(str(path))
        c_ptr, c_i64 = ctypes.c_void_p, ctypes.c_int64
        c_int = ctypes.c_int
        lib.cnnq_int8_gemm.argtypes = [c_ptr] * 8 + [c_i64] * 3 + [c_int] * 3 + [
            ctypes.c_float, c_int, c_ptr]
        lib.cnnq_int8_gemm.restype = ctypes.c_int
        _lib = lib
    return _lib


def column_vector(v, n: int, device) -> torch.Tensor:
    """``v`` (one value or ``n`` of them) as a contiguous float32 ``[n]``."""
    v = as_f32(v, device).reshape(-1)
    if v.numel() not in (1, n):
        raise ValueError(f'expected 1 or {n} per-column values, got {v.numel()}')
    return v.expand(n).contiguous()


def check_out_dtype(out_dtype):
    if out_dtype not in _DTYPES:
        raise TypeError(f'int8 kernels write float32 or bfloat16, got {out_dtype}')
    return _DTYPES[out_dtype]


def out_scale_arg(out_scale, n: int, device):
    """The codes' scale as the kernels read it: (None, 0) for a float
    output, else (a float32 scalar, 0) or (a contiguous ``[n]``, 1), one for
    each output column."""
    if out_scale is None:
        return None, 0
    s = as_f32(out_scale, device)
    if s.numel() == 1:
        return s.reshape(()), 0
    if s.numel() != n:
        raise ValueError(f'expected 1 or {n} output scales, got {s.numel()}')
    return s.reshape(-1).contiguous(), 1


def residual_arg(residual, device):
    """``(codes, scale)``: int8 codes and one float32 scale on ``device``."""
    codes, scale = residual
    if codes.dtype != torch.int8 or codes.device != device:
        raise ValueError(f'a residual is int8 codes on {device}, got {codes.dtype} on '
                         f'{codes.device}')
    s = as_f32(scale, device)
    if s.numel() != 1:
        raise ValueError(f'a residual takes one scale, got shape {tuple(s.shape)}')
    return codes, s.reshape(())


def qmax_of(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def gemm_route(k: int, aligned: bool = True) -> str:
    """The kernel route of an int8 GEMM with depth ``k``: ``'wgmma'`` where TMA
    can describe both K-major operands (every row stride a multiple of 16
    bytes, ``aligned``: both bases 16-byte aligned), else ``'mma_sync'``.
    ``csrc/int8_gemm.cu`` checks the same condition."""
    return 'wgmma' if k % 16 == 0 and aligned else 'mma_sync'


def _check_operands(a_q, b_q):
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f'int8 operands expected, got {a_q.dtype} and {b_q.dtype}')
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0] or a_q.shape[1] == 0:
        raise ValueError(f'cannot multiply {tuple(a_q.shape)} by {tuple(b_q.shape)}')


def launch(a_q, b_q, alpha, beta, fuse_relu, out_dtype, out_scale=None, out_bits=8,
           residual=None):
    """One launch of the CUDA kernel on ``a_q``'s current stream."""
    if a_q.device.type != 'cuda' or b_q.device != a_q.device:
        raise ValueError(f'int8 GEMM kernel needs CUDA tensors on one device, got '
                         f'{a_q.device} and {b_q.device}')
    _check_operands(a_q, b_q)
    code = check_out_dtype(out_dtype)
    (m, k), n = a_q.shape, b_q.shape[1]
    a = a_q.contiguous()
    bt = b_q.t().contiguous()  # no copy for a transposed view of an [N, K] weight
    alpha = column_vector(alpha, n, a.device)
    beta = None if beta is None else column_vector(beta, n, a.device)
    osc, os_vec = out_scale_arg(out_scale, n, a.device)
    res = rs = None
    if residual is not None:
        res, rs = residual_arg(residual, a.device)
        if tuple(res.shape) != (m, n):
            raise ValueError(f'residual {tuple(res.shape)} for an output of {(m, n)}')
        res = res.contiguous()
    out = torch.empty((m, n), dtype=out_dtype if osc is None else torch.int8, device=a.device)
    route = gemm_route(k, a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _library().cnnq_int8_gemm(
            a.data_ptr(), bt.data_ptr(), out.data_ptr(), alpha.data_ptr(), ptr(beta), ptr(osc),
            ptr(res), ptr(rs), m, n, k, int(fuse_relu), code, os_vec, qmax_of(out_bits),
            int(route == 'wgmma'), stream)
    if rc != 0:
        raise RuntimeError(f'int8 GEMM kernel launch failed ({route} route): CUDA error {rc}')
    counters.add(_LAUNCHES[route])
    return out


def int8_matmul_dequant(a_q, b_q, alpha, beta=None, *, fuse_relu: bool = False,
                        out_dtype=torch.float32, out_scale=None, out_bits: int = 8,
                        residual=None):
    """``a_q`` [M, K] int8, ``b_q`` [K, N] int8, ``alpha``/``beta`` [N] float32
    -> [M, N]: ``out = (a_q @ b_q) * alpha + beta`` with int32 accumulation,
    an optional ReLU, then the cast to ``out_dtype`` (float32 or bfloat16).
    ``beta=None`` adds nothing.  ``residual=(codes, scale)``, [M, N] int8 codes
    and their scale, is added before the ReLU; with ``out_scale`` (one value,
    or one a column) the output is the int8 codes of that value on the
    ``out_bits`` grid, and ``out_dtype`` the type the value travels in
    (``fused_epilogue``)."""
    counters.add('int8_gemm.codes_out', out_scale is not None)
    counters.add('int8_gemm.residual_in', residual is not None)
    if a_q.device.type == 'cpu':
        return int8_matmul_dequant_plain(a_q, b_q, alpha, beta, fuse_relu=fuse_relu,
                                         out_dtype=out_dtype, out_scale=out_scale,
                                         out_bits=out_bits, residual=residual)
    return launch(a_q, b_q, alpha, beta, fuse_relu, out_dtype, out_scale, out_bits, residual)



def int_matmul_exact(a_q, b_q) -> torch.Tensor:
    """The exact int32 product of two int8 matrices.  The CPU multiplies
    int32 directly; CUDA has no integer matmul, so the codes go through
    float64, which is exact here (|sum| <= 127^2 * K < 2^53; float32's 2^24 is
    too small), and back."""
    if a_q.device.type == 'cpu':
        return a_q.to(torch.int32) @ b_q.to(torch.int32)
    return (a_q.double() @ b_q.double()).round().to(torch.int32)


def dequant_epilogue(acc, alpha, beta, fuse_relu: bool, out_dtype, shape=(1, -1)):
    """``float(acc) * alpha``, ``+ beta``, ReLU, cast: one rounded float32
    operation each, in the kernel's order.  ``shape`` views the per-column
    vectors against ``acc`` ((1, -1) for a matrix, (1, -1, 1, 1) for NCHW)."""
    out = acc.float() * alpha.view(shape)
    if beta is not None:
        out = out + beta.view(shape)
    if fuse_relu:
        out = torch.relu(out)
    return out.to(out_dtype)


def fused_epilogue(acc, alpha, beta, fuse_relu: bool, out_dtype, *, out_scale=None,
                   out_bits: int = 8, residual=None, shape=(1, -1)):
    """The int8 kernels' whole epilogue in plain PyTorch, as the serving path
    ran it before it was fused: ``dequant_epilogue``; with ``residual=(codes,
    scale)``, + the codes dequantized in ``out_dtype`` and then the ReLU; with
    ``out_scale``, the result's codes (``quantize_sym_codes_plain``)."""
    if residual is None:
        return requant_epilogue(dequant_epilogue(acc, alpha, beta, fuse_relu, out_dtype, shape),
                                False, out_scale, out_bits, None, shape,
                                quantize=quantize_sym_codes_plain)
    return requant_epilogue(dequant_epilogue(acc, alpha, beta, False, out_dtype, shape),
                            fuse_relu, out_scale, out_bits, residual, shape,
                            quantize=quantize_sym_codes_plain)


def requant_epilogue(y, fuse_relu: bool, out_scale=None, out_bits: int = 8, residual=None,
                     shape=(1, -1), *, quantize=None):
    """What the epilogue does past the float value ``y``: + the residual's
    codes dequantized in ``y``'s type, the ReLU (``fuse_relu``, applied only
    with a residual: without one ``y`` carries it), then the codes at
    ``out_scale`` (one value, or one a column viewed as ``shape``) by
    ``quantize``, ``quantize_sym_codes`` where None."""
    if residual is not None:
        codes, scale = residual
        y = y + (codes.float() * as_f32(scale, y.device)).to(y.dtype)
        if fuse_relu:
            y = torch.relu(y)
    if out_scale is None:
        return y
    s = as_f32(out_scale, y.device)
    return (quantize or quantize_sym_codes)(y, s.view(shape) if s.numel() > 1 else s.reshape(()),
                                            out_bits)


def int8_matmul_dequant_plain(a_q, b_q, alpha, beta=None, *, fuse_relu: bool = False,
                              out_dtype=torch.float32, out_scale=None, out_bits: int = 8,
                              residual=None):
    """The plain PyTorch version of ``int8_matmul_dequant``."""
    _check_operands(a_q, b_q)
    check_out_dtype(out_dtype)
    n = b_q.shape[1]
    alpha = column_vector(alpha, n, a_q.device)
    beta = None if beta is None else column_vector(beta, n, a_q.device)
    return fused_epilogue(int_matmul_exact(a_q, b_q), alpha, beta, fuse_relu, out_dtype,
                          out_scale=out_scale, out_bits=out_bits, residual=residual)


def abs_max_scale(amax, bits: int) -> torch.Tensor:
    """The symmetric scale ``max(amax / qmax, 1e-8)`` of a ``bits``-wide grid.
    The divisor is a device tensor: true division on the card as on the CPU
    (PyTorch's CUDA division by a host scalar multiplies by the reciprocal)."""
    return torch.clamp_min(amax / as_f32(2.0 ** (bits - 1) - 1.0, amax.device), 1e-8)


def _dense(x) -> bool:
    """Whether ``x``'s elements fill its span of memory, in some order of its
    dims, with no gap and no overlap (its memory order is then that of
    ``torch.empty_strided(x.shape, x.stride())``)."""
    span = 1
    for stride, size in sorted((s, n) for s, n in zip(x.stride(), x.shape) if n != 1):
        if stride != span:
            return False
        span *= size
    return True


def codes_layout(x, scale, bits: int = 8):
    """``(channels, inner, per_channel)`` as the codes kernel reads ``x`` and
    ``scale`` (element i of ``x``'s memory takes scale ``(i // inner) %
    channels``), or None where it takes no such call: ``x`` float32 or
    bfloat16, dense in memory in any order of its dims; ``scale`` a float32
    tensor holding one value (of at most ``x``'s dims), or one a channel of
    one dim of ``x`` (1 in every other dim, adjacent in memory: the grouped
    and depthwise convs' ``scale.view(1, -1, 1, 1)``, a weight's ``[O, 1, 1,
    1]``); a grid of 2 to 8 bits.  Reads no device."""
    if (not isinstance(scale, torch.Tensor) or x.dtype not in _DTYPES
            or scale.dtype != torch.float32 or not 2 <= bits <= 8 or not _dense(x)):
        return None
    if scale.numel() == 1:
        return (1, 1, False) if scale.ndim <= x.ndim else None
    dims = [d for d, n in enumerate(scale.shape) if n != 1]
    if (scale.ndim != x.ndim or len(dims) != 1 or scale.shape[dims[0]] != x.shape[dims[0]]
            or scale.stride(dims[0]) != 1):
        return None
    return x.shape[dims[0]], x.stride(dims[0]), True


def codes_route(x, scale, bits: int = 8):
    """None for ``x`` off the card, which ``quantize_sym_codes`` quantizes by
    the plain composition; for a CUDA ``x``, dense in memory, the
    ``codes_layout`` the kernel launches with, or ValueError where the kernel
    takes no such call (``scale`` on another device included)."""
    if x.device.type != 'cuda':
        return None
    layout = codes_layout(x, scale, bits)
    if layout is None or scale.device != x.device:
        what = (f'{scale.dtype} {tuple(scale.shape)} strides {scale.stride()} on {scale.device}'
                if isinstance(scale, torch.Tensor) else type(scale).__name__)
        raise ValueError(
            f'the codes kernel takes float32 or bfloat16 x dense in memory and a float32 scale '
            f'on its device, one value or one a channel of one dim, at 2-8 bits; got x '
            f'{x.dtype} {tuple(x.shape)} strides {x.stride()}, scale {what}, {bits} bits')
    return layout


def quantize_sym_codes(x, scale, bits: int = 8) -> torch.Tensor:
    """int8 codes of ``x`` on the symmetric grid ``scale * [-qmax, qmax]``,
    qmax = 2^(bits-1) - 1, rounding half to even.  ``scale`` is a device
    tensor that broadcasts against ``x``.  On the CPU the plain composition
    ``quantize_sym_codes_plain``; for a CUDA tensor one launch of the codes
    kernel (``csrc/fake_quant.cu``), equal to it bit for bit, in ``x``'s
    layout (a strided view is copied dense first), or an error where the
    kernel takes no such call (``codes_route``)."""
    if x.device.type == 'cuda' and not _dense(x):
        x = x.contiguous()
    layout = codes_route(x, scale, bits)
    if layout is None:
        return quantize_sym_codes_plain(x, scale, bits)
    out = fake_quant.launch_codes(x, scale, qmax_of(bits), *layout)
    counters.add('quantize_codes.launches', x.numel() > 0)
    return out


def quantize_sym_codes_plain(x, scale, bits: int = 8) -> torch.Tensor:
    """The plain PyTorch version of ``quantize_sym_codes``: divide, round,
    clamp, cast."""
    qmax = qmax_of(bits)
    return torch.clamp(torch.round(x.float() / scale), -qmax, qmax).to(torch.int8)


def quantize_sym_int8(x, axis: int | None = None, *, bits: int = 8):
    """Symmetric signed quantization: codes in [-(2^(b-1)-1), 2^(b-1)-1].
    Returns (codes int8 of ``x``'s shape, scale float32); ``axis`` is the
    per-channel axis kept (scale ``[x.shape[axis]]``), None for one scale."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().amax()
    else:
        dims = tuple(i for i in range(xf.ndim) if i != axis % xf.ndim)
        amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = abs_max_scale(amax, bits)
    return quantize_sym_codes(xf, scale, bits), (scale if axis is None else scale.reshape(-1))
