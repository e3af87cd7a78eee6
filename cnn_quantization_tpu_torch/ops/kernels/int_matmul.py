"""int8 x int8 -> int32 matrix product with a fused dequant epilogue: the
wrapper of the hand-written CUDA kernel, its plain PyTorch version, and the
symmetric quantizer that makes the codes.

Replaces the Pallas TPU kernel ``cnn_quantization_tpu/ops/kernels/
int_matmul.py`` (``int8_matmul_dequant`` :58-101, body ``_matmul_kernel``
:29-46; ``quantize_sym_int8`` :104-120 is plain tensor code in both)::

    C[m, n]   = sum_k A_q[m, k] * B_q[k, n]        (int32, exact)
    out[m, n] = C[m, n] * alpha[n] + beta[n]       (float32, then optional
                                                    ReLU, then the cast)

The kernel is ``csrc/int8_gemm.cu`` (block product in ``csrc/int8_mma.cuh``),
built with nvcc for sm_90a at first use and bound with ctypes.  On the
true-int8 serving path it carries every 1x1 stride-1 convolution and the
classifier.  What bounds it depends on the shape: a 1x1 conv of an early
ResNet stage writes a float32 row for every int8 row it reads, so memory
bounds it; a late stage with K in the thousands is bounded by the int8
tensor-core rate.  Design: 128 x 64 output tiles, the K loop inside the block
with int32 sums in registers (``mma.sync.m16n8k32.s8``), 16-byte loads along K
of *both* operands, ragged M, N and K masked instead of padded.  Both operands
want K contiguous, which is how the serving path holds them: an int8 NCHW
activation in channels_last memory is a row-major ``[N*H*W, C]`` matrix, and a
1x1 OIHW weight or an ``[out, in]`` linear weight is ``B`` transposed; the
wrapper takes ``b_q`` as such a transposed view without copying.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises.  ``int8_matmul_dequant.launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.device import as_f32
from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build.build_library('int8_gemm')
        lib = ctypes.CDLL(str(path))
        c_ptr, c_i64 = ctypes.c_void_p, ctypes.c_int64
        lib.cnnq_int8_gemm.argtypes = [c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_i64, c_i64, c_i64,
                                       ctypes.c_int, ctypes.c_int, c_ptr]
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


def _check_operands(a_q, b_q):
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f'int8 operands expected, got {a_q.dtype} and {b_q.dtype}')
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0] or a_q.shape[1] == 0:
        raise ValueError(f'cannot multiply {tuple(a_q.shape)} by {tuple(b_q.shape)}')


def launch(a_q, b_q, alpha, beta, fuse_relu, out_dtype):
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
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _library().cnnq_int8_gemm(
            a.data_ptr(), bt.data_ptr(), out.data_ptr(), alpha.data_ptr(),
            None if beta is None else beta.data_ptr(), m, n, k, int(fuse_relu), code, stream)
    if rc != 0:
        raise RuntimeError(f'int8 GEMM kernel launch failed: CUDA error {rc}')
    int8_matmul_dequant.launches += 1
    return out


def int8_matmul_dequant(a_q, b_q, alpha, beta=None, *, fuse_relu: bool = False,
                        out_dtype=torch.float32):
    """``a_q`` [M, K] int8, ``b_q`` [K, N] int8, ``alpha``/``beta`` [N] float32
    -> [M, N]: ``out = (a_q @ b_q) * alpha + beta`` with int32 accumulation,
    an optional ReLU, then the cast to ``out_dtype`` (float32 or bfloat16).
    ``beta=None`` adds nothing."""
    if a_q.device.type == 'cpu':
        return int8_matmul_dequant_plain(a_q, b_q, alpha, beta, fuse_relu=fuse_relu,
                                         out_dtype=out_dtype)
    return launch(a_q, b_q, alpha, beta, fuse_relu, out_dtype)


int8_matmul_dequant.launches = 0


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


def int8_matmul_dequant_plain(a_q, b_q, alpha, beta=None, *, fuse_relu: bool = False,
                              out_dtype=torch.float32):
    """The plain PyTorch version of ``int8_matmul_dequant``."""
    _check_operands(a_q, b_q)
    check_out_dtype(out_dtype)
    n = b_q.shape[1]
    alpha = column_vector(alpha, n, a_q.device)
    beta = None if beta is None else column_vector(beta, n, a_q.device)
    return dequant_epilogue(int_matmul_exact(a_q, b_q), alpha, beta, fuse_relu, out_dtype)


def abs_max_scale(amax, bits: int) -> torch.Tensor:
    """The symmetric scale ``max(amax / qmax, 1e-8)`` of a ``bits``-wide grid.
    The divisor is a device tensor: true division on the card as on the CPU
    (PyTorch's CUDA division by a host scalar multiplies by the reciprocal)."""
    return torch.clamp_min(amax / as_f32(2.0 ** (bits - 1) - 1.0, amax.device), 1e-8)


def quantize_sym_codes(x, scale, bits: int = 8) -> torch.Tensor:
    """int8 codes of ``x`` on the symmetric grid ``scale * [-qmax, qmax]``,
    qmax = 2^(bits-1) - 1, rounding half to even.  ``scale`` is a device
    tensor that broadcasts against ``x``."""
    qmax = 2.0 ** (bits - 1) - 1.0
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
