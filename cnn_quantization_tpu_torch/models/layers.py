"""Layer primitives with quantization tap sites (NCHW, OIHW).

Port of ``cnn_quantization_tpu/models/layers.py`` (the reference's ``*WithId``
intercepting layers, inference_quantization_manager.py:28-283).  Each layer
carries a static ``Site`` and calls the explicit ``TapContext`` on its output.
Activations are logical NCHW (channels_last in memory), conv weights OIHW,
linear weights [out, in].  Float convs stay ``F.conv2d`` and float linears
``F.linear``, as the JAX package leaves them to XLA outside any Pallas kernel.
A layer's ``dtype`` is the type its activations travel in (float32, or
bfloat16 as the throughput bench builds the model): parameters stay float32,
the float path casts inputs and weights to ``dtype`` and accumulates in
float32, and the serving kernels write ``dtype``.  Under a ``ServingInt8Context`` convs and linears run true-int8 arithmetic
through the hand-written kernels (``ops/kernels/int_conv.py``,
``ops/kernels/int_matmul.py``), and in W4A4 packed serving the 1x1 convs of a
Bottleneck trunk run as the int4-packed GEMM (``ops/kernels/int4_matmul.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..engine.context import Site, TapContext
from ..ops.kernels import int4_matmul, int_conv, int_matmul
from ..utils.device import as_f32


class QTensor(NamedTuple):
    """Pre-quantized activation: int8 codes + the float32 scale they encode.

    The int8-resident serving path (ResNet blocks) quantizes a block input
    once and feeds the codes to every consumer (conv1, downsample, residual
    dequant), so only 1-byte codes travel between blocks."""
    codes: torch.Tensor   # int8, same layout as the float tensor it replaces
    scale: torch.Tensor   # float32 scalar

    def dequant(self, dtype=torch.float32):
        return (self.codes.float() * self.scale).to(dtype)


class PackedQTensor(NamedTuple):
    """Int4 codes packed two to a byte (W4A4 packed serving): the channel
    dimension is HALVED against the float tensor, ``[N, C/2, H, W]`` int8 in
    channels_last memory, so the bytes are the row-major ``[N*H*W, C/2]``
    matrix the int4 GEMM takes.  The layout is the kernel's group-local
    split-half convention (ops/kernels/int4_matmul.py); only that GEMM produces
    and consumes these on the hot path, ``dequant`` is for boundary cases (tap
    inspection)."""
    codes: torch.Tensor   # int8 bytes, [N, C/2, H, W]
    scale: torch.Tensor   # float32 scalar

    def dequant(self, dtype=torch.float32):
        codes = int4_matmul.unpack_int4(self.codes.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return (codes.float() * self.scale).to(dtype)


class SiteNamer:
    """Construction-order id counters mirroring the reference's
    ``itertools.count`` class attributes, so site ids such as
    ``conv12_activation`` match the reference's layer numbering."""

    def __init__(self):
        self.counters: dict[str, int] = {}

    def next(self, kind: str) -> int:
        i = self.counters.get(kind, 0)
        self.counters[kind] = i + 1
        return i

    def conv(self, half_range: bool = False, classifier: bool = False) -> Site:
        i = self.next('conv')
        tag = 'activation_classifier' if classifier else 'activation'
        return Site(id=f'conv{i}_activation', tag=tag, half_range=half_range, kind='conv')

    def bn(self, half_range: bool = False) -> Site:
        i = self.next('bn')
        return Site(id=f'bn{i}_activation', tag='activation', half_range=half_range, kind='bn')

    def linear(self, classifier: bool = False, half_range: bool = False) -> Site:
        i = self.next('linear')
        tag = 'activation_classifier' if classifier else 'activation_linear'
        return Site(id=f'linear{i}_activation', tag=tag,
                    half_range=half_range and not classifier, kind='linear')

    def maxpool(self) -> Site:
        i = self.next('maxpool')
        return Site(id=f'maxpool{i}_out', tag='activation_pooling', kind='maxpool')

    def avgpool(self, classifier: bool = False) -> Site:
        """AvgPool2dWithId passes its tag positionally as the ``id`` argument
        of quantize_instant (inference_quantization_manager.py:95-99), so the
        reference quantizes avgpool outputs with the *default* int8 quantizer;
        the 'default' tag mirrors that quirk (see engine/policy.py)."""
        i = self.next('avgpool')
        return Site(id=f'avgpool{i}_out', tag='default', kind='avgpool')


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _tap(ctx: TapContext, y, site: Site | None):
    return ctx.tap(y, site) if site is not None else y


def _add_bias(y, bias, shape):
    """The float32 bias added in place to a conv's or linear's low-precision
    output ``y``: the sum is taken in float32 and rounded to ``y``'s type, and
    the bias itself is never rounded."""
    return y if bias is None else y.add_(bias.view(shape))


class QConv(nn.Module):
    """Conv2d with bias and a tapped output (Conv2dWithId analogue).

    ``out_codes=True`` marks convs whose output feeds only a residual add
    (ResNet downsample convs): at serving time, when calibration froze an
    output scale (``<site>:out``), the conv emits a ``QTensor`` so the
    identity crosses device memory as 1-byte codes.

    A serving-prepared parameter tree replaces ``weight`` by int8 codes
    (OIHW, channels_last memory) and adds a ``w_scale`` entry that only such a
    tree carries; the module itself declares the float weight alone, so a
    float state dict loads strictly."""

    def __init__(self, in_ch: int, features: int, kernel_size, strides=1, padding=0,
                 groups: int = 1, use_bias: bool = True, site: Site | None = None,
                 out_codes: bool = False, dtype=torch.float32):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.dtype = dtype
        self.strides, self.padding, self.groups = _pair(strides), _pair(padding), groups
        self.in_ch, self.features = in_ch, features
        self.site, self.out_codes = site, out_codes
        self.weight = nn.Parameter(torch.empty(features, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator):
        # He-normal (fan_in), as the JAX package's he_normal init
        nn.init.kaiming_normal_(self.weight, mode='fan_in', nonlinearity='relu',
                                generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, ctx: TapContext, residual=None, out_spec=None,
                fuse_relu: bool = False):
        """``residual``/``out_spec``/``fuse_relu`` are the packed-serving block
        orchestration's inputs (models/resnet.py Bottleneck): ``residual`` is a
        ``PackedQTensor`` added (dequantized) before the fused ReLU inside the
        int4 GEMM's epilogue; ``out_spec = ('int8' | 'packed', scale)``
        requantizes the output to codes at the NEXT consumer's frozen scale.
        Outside the true-int serving path they raise: nothing there could
        honour them."""
        weight = self.weight
        # the s2d stem: prepare_serving_params(s2d_stem=True) stored the 7x7/2
        # stem kernel as an equivalent int8 [O, 12, 4, 4] stride-1 kernel
        stem_s2d = (self.in_ch == 3 and weight.dtype == torch.int8
                    and tuple(weight.shape[1:]) == (12, 4, 4))
        if getattr(ctx, 'int8_serving', False) and (stem_s2d or not (
                self.in_ch == 3 and getattr(ctx, 'bf16_first_conv', True))):
            return _tap(ctx, self._serve(x, ctx, stem_s2d, residual, out_spec, fuse_relu),
                        self.site)
        if residual is not None or out_spec is not None or fuse_relu:
            raise ValueError('residual/out_spec/fuse_relu need the true-int serving path '
                             '(a ServingInt8Context)')
        if isinstance(x, (QTensor, PackedQTensor)):  # safety: dequantize on the float path
            x = x.dequant()
        # two float paths on purpose.  float32 hands the bias to the library's
        # conv, which adds it in its epilogue: one pass over the output, and
        # the arithmetic the float32 paths' card-against-CPU bounds were
        # measured on.  A bfloat16 conv given a bias would round the bias to
        # bfloat16 first; the JAX package adds the float32 bias to the
        # conv's rounded output, and so does ``_add_bias``.
        if self.dtype == torch.float32:
            y = F.conv2d(x.float(), weight, self.bias, self.strides, self.padding,
                         groups=self.groups)
        else:
            y = _add_bias(F.conv2d(x.to(self.dtype), weight.to(self.dtype), None, self.strides,
                                   self.padding, groups=self.groups),
                          self.bias, (1, -1, 1, 1))
        return _tap(ctx, y, self.site)

    def _serve(self, x, ctx, stem_s2d: bool, residual=None, out_spec=None,
               fuse_relu: bool = False):
        """True-int path: per-tensor (per-group for grouped convs) activation
        quantization, frozen if the context holds a scale for this site, and
        per-channel int8 weights through the int8 kernels."""
        kernel_1x1 = tuple(self.weight.shape[2:]) == (1, 1)
        if (getattr(ctx, 'packed', False) and kernel_1x1 and self.in_ch != 3
                and self.groups == 1 and self.weight.dtype == torch.int8
                and (out_spec is not None or residual is not None)):
            # only when the block orchestrator drives this conv (Bottleneck
            # passes out_spec/residual); a stray 1x1 conv in packed mode (a
            # BasicBlock downsample) stays on the plain path
            return self._packed_gemm_1x1(x, ctx, residual, out_spec, fuse_relu)
        # past the packed branch: fail loudly rather than drop a residual or a
        # ReLU the packed orchestration handed over (packed mode on float
        # params, for one)
        if residual is not None or isinstance(x, PackedQTensor):
            raise ValueError('a packed residual or input needs the packed 1x1 GEMM path '
                             '(prepare_serving_params + scales frozen with packed=True)')
        if fuse_relu and out_spec is None:
            raise ValueError('fuse_relu without out_spec would be dropped outside the '
                             'packed 1x1 GEMM path')
        prequant = isinstance(x, QTensor)
        if prequant:
            x, pre_scale = x.codes, x.scale
        # the first layer (any in_ch == 3 conv) is the 8-bit exception
        # (reference i_q_m.py:336-338, 360-366); it must match
        # freeze_serving_scales' full-grid conv0 scale
        act_bits = 8 if self.in_ch == 3 else getattr(ctx, 'act_bits', 8)
        if self.weight.dtype == torch.int8:
            # offline-prepared tree: no per-call weight quantization
            w_codes, w_scale = self.weight, self.w_scale
        else:
            w_codes, w_scale = int_conv.prepare_int8_weights(
                self.weight, bits=getattr(ctx, 'weight_bits', 8))
        # grouped convs admit per-group activation scales in true-int
        # arithmetic: output channel o sums only over its group's inputs, so
        # acc[o] * gs[group_of(o)] * w_scale[o] is exact (int8_conv maps it);
        # depthwise is the fully per-channel case
        per_group = (self.groups > 1 and self.in_ch % self.groups == 0
                     and self.features % self.groups == 0)
        site_id = self.site.id if self.site is not None else None
        if prequant:
            act_scale = pre_scale
        else:
            act_scale = getattr(ctx, 'act_scales', {}).get(site_id)
            if act_scale is None:
                # dynamic abs-max; recorded so calibration can freeze it
                xf32 = x.float()
                if per_group:
                    per = self.in_ch // self.groups
                    n, _, h, w = xf32.shape
                    amax = xf32.abs().reshape(n, self.groups, per, h, w).amax(
                        dim=(0, 2, 3, 4)).repeat_interleave(per)
                else:
                    amax = xf32.abs().amax()
                act_scale = int_matmul.abs_max_scale(amax, act_bits)
                if site_id is not None and hasattr(ctx, 'record_scale'):
                    ctx.record_scale(site_id, act_scale)
                    if getattr(ctx, 'calibrate', False):
                        ctx.record_input_stats(site_id, xf32,
                                               groups=self.groups if per_group else 1)
        if stem_s2d:
            if self.strides != (2, 2) or self.padding != (3, 3):
                raise ValueError(f's2d stem kernel requires the 7x7/2 pad-3 stem, got '
                                 f'strides={self.strides} padding={self.padding}')
            # quantize the image, then pad + space-to-depth in the int8 domain
            # (zero padding is exact at zero point 0), stride-1 equivalent conv
            from ..engine.engine import s2d_stem_input
            codes = int_matmul.quantize_sym_codes(x, act_scale)
            y = int_conv.int8_conv(s2d_stem_input(codes), w_codes, w_scale, self.bias,
                                   strides=(1, 1), padding=(0, 0), act_bits=8,
                                   act_scale=act_scale, fuse_relu=fuse_relu,
                                   out_dtype=self.dtype)
        else:
            # with an out_spec the ReLU ahead of the requant runs in the conv
            # kernel's epilogue (max(., 0) gives the same values either way)
            y = int_conv.int8_conv(x if prequant else x.float(), w_codes, w_scale, self.bias,
                                   strides=self.strides, padding=self.padding,
                                   groups=self.groups, act_bits=act_bits, act_scale=act_scale,
                                   fuse_relu=fuse_relu, out_dtype=self.dtype)
        if out_spec is not None:
            # packed-serving orchestration (Bottleneck conv2): requantize the
            # int8 conv's output to codes at the NEXT consumer's frozen scale;
            # elementwise, outside any kernel as in the JAX package
            mode, oscale = out_spec[0], as_f32(out_spec[1], y.device)
            codes = int_matmul.quantize_sym_codes(y, oscale, act_bits)
            if mode == 'packed':
                packed = int4_matmul.pack_int4(codes.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                return PackedQTensor(packed, oscale)
            return QTensor(codes, oscale)
        if self.out_codes and site_id is not None:
            out_scale = getattr(ctx, 'act_scales', {}).get(site_id + ':out')
            if out_scale is None and getattr(ctx, 'calibrate', False):
                ctx.record_input_stats(site_id + ':out', y.float())
            elif out_scale is not None:
                # the identity crosses device memory as codes on the full int8
                # grid whatever act_bits is (they are only dequantized for the
                # residual add, never fed to an int conv)
                y = QTensor(int_matmul.quantize_sym_codes(y, out_scale), out_scale)
        return y

    def _packed_gemm_1x1(self, x, ctx, residual, out_spec, fuse_relu: bool):
        """Packed-serving 1x1 conv == the int4 GEMM: packed (or plain int8)
        codes in, fused dequant / residual / ReLU / requant epilogue, codes
        out, so block boundaries cross device memory at 4 bits
        (ops/kernels/int4_matmul.py); orchestrated by models/resnet.py
        Bottleneck.  A stride slices the rows spatially ahead of the GEMM."""
        act_bits = getattr(ctx, 'act_bits', 8)
        if isinstance(x, PackedQTensor):
            a, a_scale, a_packed = x.codes, x.scale, True
        elif isinstance(x, QTensor):
            a, a_scale, a_packed = x.codes, x.scale, False
        else:
            a_scale = getattr(ctx, 'act_scales', {}).get(
                self.site.id if self.site is not None else None)
            if a_scale is None:
                raise ValueError('packed serving requires frozen activation scales')
            a_scale = as_f32(a_scale, x.device)
            a, a_packed = int_matmul.quantize_sym_codes(x, a_scale, act_bits), False
        sh, sw = self.strides
        if (sh, sw) != (1, 1):
            a = a[:, :, ::sh, ::sw]
        n, cc, h, w = a.shape
        alpha = a_scale * self.w_scale.float()
        res2 = res_scale = None
        if residual is not None:
            res2 = residual.codes.permute(0, 2, 3, 1).reshape(n * h * w, -1)
            res_scale = residual.scale
        mode, out_scale = 'f32', None
        if out_spec is not None:
            mode, out_scale = out_spec[0], as_f32(out_spec[1], a.device)
        y2 = int4_matmul.int4_matmul(
            a.permute(0, 2, 3, 1).reshape(n * h * w, cc),
            self.weight.reshape(self.features, self.in_ch).t(), alpha, self.bias,
            residual=res2, res_scale=res_scale, out_scale=out_scale, a_packed=a_packed,
            fuse_relu=fuse_relu, out_mode=mode, out_qmax=2.0 ** (act_bits - 1) - 1.0,
            out_dtype=self.dtype)
        y = y2.view(n, h, w, -1).permute(0, 3, 1, 2)
        if mode == 'packed':
            return PackedQTensor(y, out_scale)
        if mode == 'int8':
            return QTensor(y, out_scale)
        return y


class QLinear(nn.Module):
    """Linear with a tapped output (LinearWithId analogue)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 site: Site | None = None, dtype=torch.float32):
        super().__init__()
        self.site, self.dtype = site, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator):
        nn.init.kaiming_normal_(self.weight, mode='fan_in', nonlinearity='relu',
                                generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, ctx: TapContext):
        if not getattr(ctx, 'int8_serving', False):
            if self.dtype == torch.float32:   # two paths as in ``QConv.forward``, and why
                y = F.linear(x.float(), self.weight, self.bias)
            else:
                y = _add_bias(F.linear(x.to(self.dtype), self.weight.to(self.dtype)),
                              self.bias, (1, -1))
            return _tap(ctx, y, self.site)
        # true-int path; the classifier/linear stays 8-bit whatever the conv
        # bit widths are (reference weight_classifier/activation_classifier
        # policy, i_q_m.py:414, 437)
        if self.weight.dtype == torch.int8:
            w_codes, w_scale = self.weight, self.w_scale
        else:
            w_codes, w_scale = int_matmul.quantize_sym_int8(self.weight, axis=0, bits=8)
        site_id = self.site.id if self.site is not None else None
        act_scale = getattr(ctx, 'act_scales', {}).get(site_id)
        xf = x.float()
        if act_scale is None:
            act_scale = int_matmul.abs_max_scale(xf.abs().amax(), 8)
            if site_id is not None and hasattr(ctx, 'record_scale'):
                ctx.record_scale(site_id, act_scale)
                if getattr(ctx, 'calibrate', False):
                    ctx.record_input_stats(site_id, xf)
        x_q = int_matmul.quantize_sym_codes(xf, act_scale)
        y = int_matmul.int8_matmul_dequant(x_q.reshape(-1, x_q.shape[-1]), w_codes.t(),
                                           act_scale * w_scale, self.bias,
                                           out_dtype=self.dtype)
        return _tap(ctx, y.reshape(*x_q.shape[:-1], -1), self.site)


class QBatchNorm(nn.Module):
    """Inference-mode BatchNorm2d with a tapped output; only built for
    architectures whose BN is not folded into the preceding conv."""

    def __init__(self, features: int, eps: float = 1e-5, site: Site | None = None,
                 dtype=torch.float32):
        super().__init__()
        self.eps, self.site, self.dtype = eps, site, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x, ctx: TapContext):
        shape = (1, -1, 1, 1)
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        y = (x.float() - self.running_mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
        return _tap(ctx, y.to(self.dtype), self.site)


class QMaxPool(nn.Module):
    """MaxPool2d with a tapped output (MaxPool2dWithId analogue)."""

    def __init__(self, window, strides, padding=0, ceil_mode: bool = False,
                 site: Site | None = None):
        super().__init__()
        self.window, self.strides, self.padding = _pair(window), _pair(strides), _pair(padding)
        self.ceil_mode, self.site = ceil_mode, site

    def forward(self, x, ctx: TapContext):
        if isinstance(x, QTensor):
            # max commutes with the (monotone, symmetric) dequant, so the pool
            # runs on the codes.  max_pool2d has no int8 kernel on CUDA: the
            # codes pool as float16, exact for |code| <= 127; its -inf padding
            # never wins, as every window of a pool whose padding is below its
            # window holds a real element
            y = F.max_pool2d(x.codes.to(torch.float16), self.window, self.strides,
                             self.padding, ceil_mode=self.ceil_mode)
            return _tap(ctx, QTensor(y.to(torch.int8), x.scale), self.site)
        y = F.max_pool2d(x, self.window, self.strides, self.padding,
                         ceil_mode=self.ceil_mode)
        return _tap(ctx, y, self.site)


class QAvgPool(nn.Module):
    """AvgPool2d (count_include_pad=True) with a tapped output.
    ``window=None`` pools over the input's height, as the JAX ResNet sizes its
    final pool from the feature map it receives."""

    def __init__(self, window=None, strides=None, padding=0, site: Site | None = None):
        super().__init__()
        self.window, self.strides, self.padding = window, strides, _pair(padding)
        self.site = site

    def forward(self, x, ctx: TapContext):
        w = _pair(self.window if self.window is not None else x.shape[2])
        s = _pair(self.strides) if self.strides is not None else w
        y = F.avg_pool2d(x.float(), w, s, self.padding, count_include_pad=True)
        return _tap(ctx, y.to(x.dtype), self.site)


class QGlobalAvgPool(nn.Module):
    """Adaptive 1x1 average pool, tapped like AvgPool2dWithId."""

    def __init__(self, site: Site | None = None):
        super().__init__()
        self.site = site

    def forward(self, x, ctx: TapContext):
        y = torch.mean(x.float(), dim=(2, 3), keepdim=True).to(x.dtype)
        return _tap(ctx, y, self.site)


def relu(x):
    """ReLU: the reference disables quantization of ReLU outputs
    (ReLUWithId, i_q_m.py:28-48), so no tap."""
    return torch.relu(x)


class Slot(nn.Module):
    """A parameter-free member of a torchvision ``Sequential`` (a Dropout, a
    BN folded away) kept so the container's indices, and with them the
    state-dict names (``features.10``, ``classifier.6``), stay torchvision's;
    the identity at inference."""

    def forward(self, x, ctx: TapContext):
        return x


class ReLU(Slot):
    """The ``nn.ReLU`` member of a torchvision ``Sequential`` (untapped)."""

    def forward(self, x, ctx: TapContext):
        return relu(x)


def run_all(mods, x, ctx: TapContext):
    """Each module of ``mods`` in turn (a torchvision ``Sequential``)."""
    for m in mods:
        x = m(x, ctx)
    return x


def init_parameters(model: nn.Module, seed: int):
    """Seeded He-normal init of every conv and linear, in module order, from
    one CPU ``torch.Generator`` (the same weights whatever the device)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (QConv, QLinear)):
                m.reset_parameters(gen)
    return model
