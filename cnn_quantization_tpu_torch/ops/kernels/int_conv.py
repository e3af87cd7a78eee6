"""True-int8 convolution: quantize -> int8 conv (int32 accumulate) -> dequant
epilogue.  The wrapper of the hand-written CUDA kernel, its plain PyTorch
version, and the serving conv ``int8_conv`` built on them.

Port of ``cnn_quantization_tpu/ops/kernels/int_conv.py``.  There ``int8_conv``
(:63-108) is XLA's native int8 convolution; PyTorch on CUDA has no integer
convolution, so the port writes it by hand: ``csrc/int8_conv.cu``, an
implicit GEMM on the block product of ``csrc/int8_mma.cuh`` (no im2col buffer
in device memory), built with nvcc for sm_90a at first use and bound with
ctypes.  Activations are logical NCHW in channels_last memory, weights OIHW
prepared once in channels_last memory so K runs (kh, kw, c) contiguously; zero
padding happens in the integer domain (exact at zero point 0); strides,
padding and groups (grouped and depthwise through a generic per-byte gather)
are general.  A 3x3 conv of ResNet-50 does 2*9*C operations per output, which
costs one int8 byte read and four float32 bytes written: up to C = 128 the
memory rate bounds it, from C = 256 on the int8 tensor-core rate.

``int8_conv`` keeps the JAX signature (layouts apart).  A convolution that is
a plain matrix product (1x1, stride 1, no padding, one group) goes to the int8
GEMM kernel (``int_matmul.int8_matmul_dequant``), as the 1x1 shortcut of the
JAX package's ``int8_conv_im2col`` (:139-141) does; every other shape goes to
``int8_conv_dequant``.

For tensors on the CPU the wrappers run the plain versions; for CUDA tensors
they launch the kernels or raise.  ``int8_conv_dequant.launches`` counts
launches of the conv kernel, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils.device import as_f32
from . import build, int_matmul
from .int_matmul import quantize_sym_codes, quantize_sym_int8

_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build.build_library('int8_conv')
        lib = ctypes.CDLL(str(path))
        c_ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.cnnq_int8_conv.argtypes = [c_ptr] * 5 + [c_int] * 14 + [c_ptr]
        lib.cnnq_int8_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def prepare_int8_weights(kernel, *, bits: int = 8):
    """Offline per-output-channel symmetric quantization of an OIHW kernel.
    Returns (codes [O, I, KH, KW] int8 in channels_last memory, scale [O])."""
    codes, scale = quantize_sym_int8(kernel, axis=0, bits=bits)
    return codes.contiguous(memory_format=torch.channels_last), scale


def _quantize_act(x, act_bits: int, act_scale):
    """(int8 codes, float32 scale) of an NCHW activation.  int8 input is
    already codes and needs the scale it was quantized with; a vector scale
    holds one value per input channel."""
    if act_scale is None:
        if x.dtype == torch.int8:
            raise ValueError('int8 codes input requires act_scale')
        return quantize_sym_int8(x.float(), bits=act_bits)
    scale = as_f32(act_scale, x.device)
    if scale.ndim == 1 and scale.shape[0] != x.shape[1]:
        raise ValueError(f'activation scale vector of {scale.shape[0]} for '
                         f'{x.shape[1]} input channels')
    if x.dtype == torch.int8:
        return x, scale
    per = scale.view(1, -1, 1, 1) if scale.ndim == 1 else scale
    return quantize_sym_codes(x, per, act_bits), scale


def _check_conv(x_q, w_codes, strides, padding, groups):
    if x_q.dtype != torch.int8 or w_codes.dtype != torch.int8:
        raise TypeError(f'int8 operands expected, got {x_q.dtype} and {w_codes.dtype}')
    if x_q.ndim != 4 or w_codes.ndim != 4:
        raise ValueError('int8 conv takes an NCHW input and an OIHW weight')
    c, (o, cg, kh, kw) = x_q.shape[1], w_codes.shape
    if groups < 1 or c != cg * groups or o % groups:
        raise ValueError(f'input channels {c}, weight {tuple(w_codes.shape)} and groups '
                         f'{groups} do not fit')
    (sh, sw), (ph, pw) = strides, padding
    if min(sh, sw) < 1 or min(ph, pw) < 0 or x_q.shape[2] + 2 * ph < kh \
            or x_q.shape[3] + 2 * pw < kw:
        raise ValueError(f'invalid strides {strides} / padding {padding} for input '
                         f'{tuple(x_q.shape)} and weight {tuple(w_codes.shape)}')


def launch(x_q, w_codes, alpha, bias, strides, padding, groups, fuse_relu, out_dtype):
    """One launch of the CUDA kernel on ``x_q``'s current stream; returns the
    NCHW output in channels_last memory."""
    if x_q.device.type != 'cuda' or w_codes.device != x_q.device:
        raise ValueError(f'int8 conv kernel needs CUDA tensors on one device, got '
                         f'{x_q.device} and {w_codes.device}')
    _check_conv(x_q, w_codes, strides, padding, groups)
    code = int_matmul.check_out_dtype(out_dtype)
    # the kernel's layouts: NHWC image, [O, KH, KW, Cg] weight (no copy when
    # the tensors already lie in channels_last memory)
    x = x_q.permute(0, 2, 3, 1).contiguous()
    w = w_codes.permute(0, 2, 3, 1).contiguous()
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    (sh, sw), (ph, pw) = strides, padding
    ho, wo = (h + 2 * ph - kh) // sh + 1, (wd + 2 * pw - kw) // sw + 1
    alpha = int_matmul.column_vector(alpha, o, x.device)
    bias = None if bias is None else int_matmul.column_vector(bias, o, x.device)
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().cnnq_int8_conv(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), alpha.data_ptr(),
            None if bias is None else bias.data_ptr(), n, h, wd, c, o, kh, kw, sh, sw, ph, pw,
            groups, int(fuse_relu), code, stream)
    if rc != 0:
        raise RuntimeError(f'int8 conv kernel launch failed: CUDA error {rc}')
    int8_conv_dequant.launches += 1
    return out.permute(0, 3, 1, 2)


def int8_conv_dequant(x_q, w_codes, alpha, bias=None, *, strides=(1, 1), padding=(0, 0),
                      groups: int = 1, fuse_relu: bool = False, out_dtype=torch.float32):
    """int8 codes in, dequantized activations out: ``x_q`` [N, C, H, W] int8,
    ``w_codes`` [O, C/groups, KH, KW] int8, ``alpha``/``bias`` [O] float32 ->
    ``conv(x_q, w_codes) * alpha + bias`` with int32 accumulation, an
    optional ReLU, then the cast to ``out_dtype``."""
    strides, padding = tuple(strides), tuple(padding)
    if x_q.device.type == 'cpu':
        return int8_conv_dequant_plain(x_q, w_codes, alpha, bias, strides=strides,
                                       padding=padding, groups=groups, fuse_relu=fuse_relu,
                                       out_dtype=out_dtype)
    return launch(x_q, w_codes, alpha, bias, strides, padding, groups, fuse_relu, out_dtype)


int8_conv_dequant.launches = 0


def int_conv_exact(x_q, w_codes, strides, padding, groups) -> torch.Tensor:
    """The exact int32 convolution of int8 codes.  The CPU convolves int32
    directly; CUDA's convolutions are floating point only, so the codes go
    through float64, exact for these sums (< 2^53), and are rounded back (the
    rounding also removes what a transform-based algorithm could add)."""
    if x_q.device.type == 'cpu':
        return F.conv2d(x_q.to(torch.int32), w_codes.to(torch.int32), None, strides, padding,
                        groups=groups)
    return F.conv2d(x_q.double(), w_codes.double(), None, strides, padding,
                    groups=groups).round().to(torch.int32)


def int8_conv_dequant_plain(x_q, w_codes, alpha, bias=None, *, strides=(1, 1),
                            padding=(0, 0), groups: int = 1, fuse_relu: bool = False,
                            out_dtype=torch.float32):
    """The plain PyTorch version of ``int8_conv_dequant``."""
    strides, padding = tuple(strides), tuple(padding)
    _check_conv(x_q, w_codes, strides, padding, groups)
    int_matmul.check_out_dtype(out_dtype)
    o = w_codes.shape[0]
    alpha = int_matmul.column_vector(alpha, o, x_q.device)
    bias = None if bias is None else int_matmul.column_vector(bias, o, x_q.device)
    acc = int_conv_exact(x_q, w_codes, strides, padding, groups)
    return int_matmul.dequant_epilogue(acc, alpha, bias, fuse_relu, out_dtype,
                                       shape=(1, -1, 1, 1))


def int8_conv(x, w_codes, w_scale, bias=None, *, kernel_size=None, strides=(1, 1),
              padding=(0, 0), groups: int = 1, act_bits: int = 8, act_scale=None,
              fuse_relu: bool = False, out_dtype=torch.float32, interpret=None):
    """Quantize ``x`` (NCHW float, or int8 codes with ``act_scale`` their
    scale), convolve in int8, dequantize.  ``w_codes`` [O, I, KH, KW] int8 and
    ``w_scale`` [O] come from ``prepare_int8_weights``.  ``act_scale`` is a
    scalar or an ``[in_ch]`` vector constant within each group.
    ``kernel_size``/``interpret`` are accepted for the JAX signature (the
    shape comes from ``w_codes``)."""
    del kernel_size, interpret
    strides, padding = tuple(strides), tuple(padding)
    x_q, x_scale = _quantize_act(x, act_bits, act_scale)
    features, cg, kh, kw = w_codes.shape
    if x_scale.ndim == 1:
        # the scale factors out of the integer sum per group: output channel o
        # sums only over its group's inputs, so the epilogue needs
        # gs[group_of(o)] per output channel
        gs = x_scale.reshape(groups, cg)[:, 0]
        x_scale_out = gs.repeat_interleave(features // groups)
    else:
        x_scale_out = x_scale
    alpha = x_scale_out * w_scale.float()
    if (kh, kw) == (1, 1) and strides == (1, 1) and padding == (0, 0) and groups == 1:
        n, c, h, w = x_q.shape
        a = x_q.permute(0, 2, 3, 1).reshape(n * h * w, c)
        out = int_matmul.int8_matmul_dequant(a, w_codes.reshape(features, c).t(), alpha, bias,
                                             fuse_relu=fuse_relu, out_dtype=out_dtype)
        return out.view(n, h, w, features).permute(0, 3, 1, 2)
    return int8_conv_dequant(x_q, w_codes, alpha, bias, strides=strides, padding=padding,
                             groups=groups, fuse_relu=fuse_relu, out_dtype=out_dtype)
