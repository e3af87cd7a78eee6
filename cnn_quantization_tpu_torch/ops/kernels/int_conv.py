"""True-int8 convolution: quantize -> int8 conv (int32 accumulate) -> dequant
epilogue.  The wrapper of the hand-written CUDA kernel, its plain PyTorch
version, and the serving conv ``int8_conv`` built on them.

Port of ``cnn_quantization_tpu/ops/kernels/int_conv.py``.  There ``int8_conv``
(:63-108) is XLA's native int8 convolution; PyTorch on CUDA has no integer
convolution, so the port writes it by hand: ``csrc/int8_conv.cu``, built with
nvcc for sm_90a at first use and bound with ctypes.  Activations are logical
NCHW in channels_last memory, weights OIHW prepared once in channels_last
memory so K runs (kh, kw, c) contiguously; zero padding happens in the
integer domain (exact at zero point 0); strides, padding and groups are
general.  Three routes, chosen by ``conv_route`` from the shape:

* ``'depthwise'`` (groups == C == O, any filter, stride and padding): a direct
  kernel without tensor cores, a thread for 16 channels of one output
  position, four filter taps of a channel summed by one ``__dp4a``; memory
  bounds it (a float32 output is four bytes for every int8 input byte);
* ``'im2col_wgmma'`` (one group, C a multiple of 64, 16-byte aligned
  operands, what TMA's im2col mode can describe: every 3x3 conv and strided
  1x1 downsample of the ResNet family): the persistent TMA + ``wgmma`` kernel
  of ``csrc/int8_wgmma.cuh``, its A tiles loaded by TMA in im2col mode (128
  output pixels x one filter tap x 64 or 128 channels a load, padding by
  TMA's zero fill), so no im2col buffer is written to device memory.  A 3x3
  conv of ResNet-50 does 2*9*C operations per output, which costs one int8
  byte read and four float32 bytes written: up to C = 128 the memory rate
  bounds it, from C = 256 on the int8 tensor-core rate;
* ``'implicit_gemm'`` for every other conv (the space-to-depth stem with
  Cg = 12, ResNeXt's groups, depthwise with a multiplier): the block product
  of ``csrc/int8_mma.cuh`` with the image gathered on the fly by the
  threads.

``int8_conv`` keeps the JAX signature (layouts apart).  A convolution that is
a plain matrix product (1x1, stride 1, no padding, one group) goes to the int8
GEMM kernel (``int_matmul.int8_matmul_dequant``), as the 1x1 shortcut of the
JAX package's ``int8_conv_im2col`` (:139-141) does; every other shape goes to
``int8_conv_dequant``.  ``int8_conv_im2col`` (the JAX package's explicit
lowering, :126-154) writes the patches to device memory and multiplies them
with the int8 GEMM kernel; it computes what ``int8_conv`` computes, bit for
bit, and is kept as a cross-check of the implicit-GEMM kernel.

The space-to-depth stem's format lives here beside the weights':
``s2d_stem_kernel`` rewrites the 7x7/2 stem as a stride-1 [O, 12, 4, 4]
kernel, ``s2d_stem_input`` its input, and ``is_s2d_stem_weight`` recognises
the prepared kernel.

The tensor-core routes' epilogue can also take a residual in and hand codes
out, as the GEMM's (``int_matmul.fused_epilogue``); the depthwise kernel has
neither, so there ``int8_conv_dequant`` writes floats and composes them with
``int_matmul.requant_epilogue``.

For tensors on the CPU the wrappers run the plain versions; for CUDA tensors
they launch the kernels or raise.  The conv kernel's launches by route, the
calls of ``int8_conv_dequant`` that emit codes or add a residual, and the bytes
of floats ``int8_conv`` and ``int8_conv_im2col`` quantize themselves are
counted in the port's one store, ``utils/counters.py``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils import counters
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
        lib.cnnq_int8_conv.argtypes = [c_ptr] * 8 + [c_int] * 15 + [ctypes.c_float, c_int, c_ptr]
        lib.cnnq_int8_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def prepare_int8_weights(kernel, *, bits: int = 8):
    """Offline per-output-channel symmetric quantization of an OIHW kernel.
    Returns (codes [O, I, KH, KW] int8 in channels_last memory, scale [O])."""
    codes, scale = quantize_sym_int8(kernel, axis=0, bits=bits)
    return codes.contiguous(memory_format=torch.channels_last), scale


def s2d_stem_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Space-to-depth transform of a 7x7/2 pad-3 stem kernel [O, 3, 7, 7] to
    the equivalent stride-1 kernel [O, 12, 4, 4].

    Output row i of the original conv covers padded-image rows 2i..2i+6.
    After s2d by 2 (channel order: row phase, col phase, channel), s2d row
    i+j holds padded rows (2(i+j), 2(i+j)+1), so the window is s2d rows
    i..i+3 with tap [j, phase] = w8[2j+phase], w8 being the 7x7 kernel
    zero-padded to 8x8."""
    o, c = kernel.shape[:2]
    w8 = F.pad(kernel, (0, 1, 0, 1))                       # [O, C, 8, 8]
    return (w8.reshape(o, c, 4, 2, 4, 2)                   # o, c, j, ph, i, pw
            .permute(0, 3, 5, 1, 2, 4)                     # o, ph, pw, c, j, i
            .reshape(o, 4 * c, 4, 4))


def s2d_stem_input(x: torch.Tensor) -> torch.Tensor:
    """pad(x, 3) then space-to-depth by 2: [N, C, H, W] -> [N, 4C, (H+6)/2,
    (W+6)/2] (channel order row phase, col phase, channel, as
    ``s2d_stem_kernel``), in channels_last memory.  Needs H and W even.  For
    int8 codes the zero padding is exact (zero point 0)."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f's2d stem needs an even input size, got {h}x{w}')
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 3, 3, 3, 3))  # NHWC, H and W padded
    h, w = h + 6, w + 6
    return (xp.reshape(n, h // 2, 2, w // 2, 2, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4 * c)
            .permute(0, 3, 1, 2))


def is_s2d_stem_weight(weight: torch.Tensor) -> bool:
    """Whether ``weight`` is a prepared space-to-depth stem: the int8 codes
    of an [O, 12, 4, 4] ``s2d_stem_kernel``."""
    return weight.dtype == torch.int8 and weight.ndim == 4 and tuple(weight.shape[1:]) == (12, 4, 4)


def _quantize_act(x, act_bits: int, act_scale):
    """(int8 codes, float32 scale) of an NCHW activation.  int8 input is
    already codes and needs the scale it was quantized with; a vector scale
    holds one value per input channel."""
    if act_scale is None:
        if x.dtype == torch.int8:
            raise ValueError('int8 codes input requires act_scale')
        counters.add('int8_conv.float_in_bytes', x.numel() * x.element_size())
        return quantize_sym_int8(x.float(), bits=act_bits)
    scale = as_f32(act_scale, x.device)
    if scale.ndim == 1 and scale.shape[0] != x.shape[1]:
        raise ValueError(f'activation scale vector of {scale.shape[0]} for '
                         f'{x.shape[1]} input channels')
    if x.dtype == torch.int8:
        return x, scale
    counters.add('int8_conv.float_in_bytes', x.numel() * x.element_size())
    per = scale.view(1, -1, 1, 1) if scale.ndim == 1 else scale
    return quantize_sym_codes(x, per, act_bits), scale


_ROUTE_CODES = {'implicit_gemm': 0, 'depthwise': 1, 'im2col_wgmma': 2}
_LAUNCHES = {'implicit_gemm': 'int8_conv.implicit_gemm', 'depthwise': 'int8_conv.depthwise',
             'im2col_wgmma': 'int8_conv.im2col_wgmma'}


def conv_route(in_ch: int, out_ch: int, groups: int, *, kernel=(1, 1), strides=(1, 1),
               padding=(0, 0), aligned: bool = True) -> str:
    """The kernel route of an int8 conv: ``'depthwise'`` for groups == in_ch
    == out_ch (one filter per channel); ``'im2col_wgmma'`` where TMA's im2col
    mode can describe the image (one group, in_ch a multiple of 64,
    ``aligned``: both bases 16-byte aligned, strides at most 8, filter and
    padding at most 32); else ``'implicit_gemm'``.  ``csrc/int8_conv.cu``
    checks the same condition (``im2col_describable`` in
    ``csrc/int8_wgmma.cuh``)."""
    if groups == in_ch == out_ch:
        return 'depthwise'
    if (groups == 1 and in_ch % 64 == 0 and aligned and max(strides) <= 8
            and max(kernel) <= 32 and max(padding) <= 32):
        return 'im2col_wgmma'
    return 'implicit_gemm'


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


def launch(x_q, w_codes, alpha, bias, strides, padding, groups, fuse_relu, out_dtype,
           route=None, out_scale=None, out_bits=8, residual=None):
    """One launch of the CUDA kernel on ``x_q``'s current stream; returns the
    NCHW output in channels_last memory.  ``route`` None takes
    ``conv_route``'s; ``'implicit_gemm'``, which computes every shape, may be
    asked for to measure it beside that route.  The depthwise route takes no
    ``out_scale`` or ``residual``."""
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
    osc, os_vec = int_matmul.out_scale_arg(out_scale, o, x.device)
    res = rs = None
    if residual is not None:
        res, rs = int_matmul.residual_arg(residual, x.device)
        if tuple(res.shape) != (n, o, ho, wo):
            raise ValueError(f'residual {tuple(res.shape)} for an output of {(n, o, ho, wo)}')
        res = res.permute(0, 2, 3, 1).contiguous()   # out's NHWC layout
    out = torch.empty((n, ho, wo, o), dtype=out_dtype if osc is None else torch.int8,
                      device=x.device)
    own = conv_route(c, o, groups, kernel=(kh, kw), strides=(sh, sw), padding=(ph, pw),
                     aligned=x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    route = own if route is None else route
    if route not in (own, 'implicit_gemm'):
        raise ValueError(f'the {route} route cannot take this conv; its route is {own}')
    if route == 'depthwise' and (osc is not None or res is not None):
        raise ValueError('the depthwise route writes floats: no out_scale or residual')
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().cnnq_int8_conv(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), alpha.data_ptr(), ptr(bias), ptr(osc),
            ptr(res), ptr(rs), n, h, wd, c, o, kh, kw, sh, sw, ph, pw, groups, int(fuse_relu),
            code, os_vec, int_matmul.qmax_of(out_bits), _ROUTE_CODES[route], stream)
    if rc != 0:
        raise RuntimeError(f'int8 conv kernel launch failed ({route} route): CUDA error {rc}')
    counters.add(_LAUNCHES[route])
    return out.permute(0, 3, 1, 2)


def int8_conv_dequant(x_q, w_codes, alpha, bias=None, *, strides=(1, 1), padding=(0, 0),
                      groups: int = 1, fuse_relu: bool = False, out_dtype=torch.float32,
                      out_scale=None, out_bits: int = 8, residual=None):
    """int8 codes in, dequantized activations out: ``x_q`` [N, C, H, W] int8,
    ``w_codes`` [O, C/groups, KH, KW] int8, ``alpha``/``bias`` [O] float32 ->
    ``conv(x_q, w_codes) * alpha + bias`` with int32 accumulation, an
    optional ReLU, then the cast to ``out_dtype``.  ``residual`` and
    ``out_scale``/``out_bits`` as ``int_matmul.int8_matmul_dequant``'s, the
    residual's codes [N, O, Ho, Wo]."""
    strides, padding = tuple(strides), tuple(padding)
    if x_q.device.type == 'cpu':
        counters.add('int8_conv.codes_out', out_scale is not None)
        counters.add('int8_conv.residual_in', residual is not None)
        return int8_conv_dequant_plain(x_q, w_codes, alpha, bias, strides=strides,
                                       padding=padding, groups=groups, fuse_relu=fuse_relu,
                                       out_dtype=out_dtype, out_scale=out_scale,
                                       out_bits=out_bits, residual=residual)
    if groups == x_q.shape[1] == w_codes.shape[0] and (out_scale is not None
                                                       or residual is not None):
        # the depthwise kernel writes floats: the rest of the epilogue in PyTorch
        y = launch(x_q, w_codes, alpha, bias, strides, padding, groups,
                   fuse_relu and residual is None, out_dtype)
        return int_matmul.requant_epilogue(y, fuse_relu, out_scale, out_bits, residual,
                                           shape=(1, -1, 1, 1))
    counters.add('int8_conv.codes_out', out_scale is not None)
    counters.add('int8_conv.residual_in', residual is not None)
    return launch(x_q, w_codes, alpha, bias, strides, padding, groups, fuse_relu, out_dtype,
                  out_scale=out_scale, out_bits=out_bits, residual=residual)



def int_conv_exact(x_q, w_codes, strides, padding, groups) -> torch.Tensor:
    """The exact int32 convolution of int8 codes.  The CPU convolves int32
    directly; CUDA's convolutions are floating point only, so the codes go
    through float64, exact for these sums (< 2^53), and are rounded back (the
    rounding also removes what a transform-based algorithm could add).  On
    CUDA the sums come out in channels_last memory, as the kernel's do
    (PyTorch's grouped and depthwise float64 convs return NCHW): a forward
    through the plain versions then runs its later float ops, a pooling
    mean among them, in the same order as the kernel's forward."""
    if x_q.device.type == 'cpu':
        return F.conv2d(x_q.to(torch.int32), w_codes.to(torch.int32), None, strides, padding,
                        groups=groups)
    return F.conv2d(x_q.double(), w_codes.double(), None, strides, padding,
                    groups=groups).round().to(torch.int32) \
        .contiguous(memory_format=torch.channels_last)


def int8_conv_dequant_plain(x_q, w_codes, alpha, bias=None, *, strides=(1, 1),
                            padding=(0, 0), groups: int = 1, fuse_relu: bool = False,
                            out_dtype=torch.float32, out_scale=None, out_bits: int = 8,
                            residual=None):
    """The plain PyTorch version of ``int8_conv_dequant``."""
    strides, padding = tuple(strides), tuple(padding)
    _check_conv(x_q, w_codes, strides, padding, groups)
    int_matmul.check_out_dtype(out_dtype)
    o = w_codes.shape[0]
    alpha = int_matmul.column_vector(alpha, o, x_q.device)
    bias = None if bias is None else int_matmul.column_vector(bias, o, x_q.device)
    acc = int_conv_exact(x_q, w_codes, strides, padding, groups)
    return int_matmul.fused_epilogue(acc, alpha, bias, fuse_relu, out_dtype, out_scale=out_scale,
                                     out_bits=out_bits, residual=residual, shape=(1, -1, 1, 1))


def int8_conv(x, w_codes, w_scale, bias=None, *, kernel_size=None, strides=(1, 1),
              padding=(0, 0), groups: int = 1, act_bits: int = 8, act_scale=None,
              fuse_relu: bool = False, out_dtype=torch.float32, interpret=None,
              out_scale=None, out_bits: int = 8, residual=None):
    """Quantize ``x`` (NCHW float, or int8 codes with ``act_scale`` their
    scale), convolve in int8, dequantize.  ``w_codes`` [O, I, KH, KW] int8 and
    ``w_scale`` [O] come from ``prepare_int8_weights``.  ``act_scale`` is a
    scalar or an ``[in_ch]`` vector constant within each group.
    ``residual=(codes, scale)`` ([N, O, Ho, Wo] int8 codes) is added before the
    ReLU, and with ``out_scale`` the output is int8 codes on the ``out_bits``
    grid (``int8_conv_dequant``).  ``kernel_size``/``interpret`` are accepted
    for the JAX signature (the shape comes from ``w_codes``)."""
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
    epilogue = dict(fuse_relu=fuse_relu, out_dtype=out_dtype, out_scale=out_scale,
                    out_bits=out_bits)
    if (kh, kw) == (1, 1) and strides == (1, 1) and padding == (0, 0) and groups == 1:
        n, c, h, w = x_q.shape
        a = x_q.permute(0, 2, 3, 1).reshape(n * h * w, c)
        res = None
        if residual is not None:
            res = (residual[0].permute(0, 2, 3, 1).reshape(n * h * w, features), residual[1])
        out = int_matmul.int8_matmul_dequant(a, w_codes.reshape(features, c).t(), alpha, bias,
                                             residual=res, **epilogue)
        return out.view(n, h, w, features).permute(0, 3, 1, 2)
    return int8_conv_dequant(x_q, w_codes, alpha, bias, strides=strides, padding=padding,
                             groups=groups, residual=residual, **epilogue)


def _extract_patches(x_q, kh: int, kw: int, strides, padding) -> torch.Tensor:
    """NCHW int8 codes -> [N*Ho*Wo, KH*KW*C] patches, feature order
    (kh, kw, c), with (Ho, Wo).  Zero padding in the integer domain (exact at
    zero point 0); the windows are strided views until the final reshape
    copies them (``F.unfold`` itself takes floating types only)."""
    (sh, sw), (ph, pw) = strides, padding
    xp = F.pad(x_q, (pw, pw, ph, ph))
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)        # [N, C, Ho, Wo, KH, KW]
    n, c, ho, wo = win.shape[:4]
    return win.permute(0, 2, 3, 4, 5, 1).reshape(n * ho * wo, kh * kw * c), (ho, wo)


def int8_conv_im2col(x, w_codes, w_scale, bias=None, *, strides=(1, 1), padding=(0, 0),
                     act_bits: int = 8, act_scale=None, fuse_relu: bool = False,
                     out_dtype=torch.float32):
    """im2col + the int8 GEMM kernel: the explicit lowering of ``int8_conv``
    for ungrouped convs with a per-tensor activation scale.  ``w_codes``
    [O, I, KH, KW] int8 as for ``int8_conv``."""
    strides, padding = tuple(strides), tuple(padding)
    features, ic, kh, kw = w_codes.shape
    if x.shape[1] != ic:
        raise ValueError('groups unsupported on the im2col path')
    x_q, x_scale = _quantize_act(x, act_bits, act_scale)
    if x_scale.ndim:
        raise ValueError('the im2col path takes a per-tensor activation scale')
    n = x_q.shape[0]
    patches, (ho, wo) = _extract_patches(x_q, kh, kw, strides, padding)
    w2 = w_codes.permute(0, 2, 3, 1).reshape(features, kh * kw * ic)   # K runs (kh, kw, c)
    out = int_matmul.int8_matmul_dequant(patches, w2.t(), x_scale * w_scale.float(), bias,
                                         fuse_relu=fuse_relu, out_dtype=out_dtype)
    return out.view(n, ho, wo, features).permute(0, 3, 1, 2)
