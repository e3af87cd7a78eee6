"""ResNet family (NCHW in channels_last memory): the simulation path, the
int8-resident true-int8 serving path and the W4A4 packed serving trunk.

Port of ``cnn_quantization_tpu/models/resnet.py``.  Module and parameter names follow
torchvision (``layer1.0.conv1.weight``, ``layer1.0.downsample.0.weight``), and
site ids replicate the reference's construction-order numbering: downsample
convs are numbered before the convs of a stage's first block.  BN is folded
into the convs for this family (convs carry biases, no BN modules); the
before-ReLU half-range marks (utils/mark_relu.py) are baked into the sites.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..engine.context import Site, TapContext
from ..ops.kernels.int_matmul import quantize_sym_codes
from ..utils.spans import traced
from .layers import (PackedQTensor, QAvgPool, QBatchNorm, QConv, QLinear, QMaxPool, QTensor,
                     SiteNamer, relu, run_all)


def _codes_scales(spec, ctx):
    """The frozen scales a block's int8-resident serving path reads: each
    conv's input scale, then the downsample's identity scale
    (``<site>:out``).  None off the true-int path, with BN live, or where one
    is absent (calibration, dynamic serving): the block then runs on floats."""
    if not ctx.int8_serving or not spec.fold_bn:
        return None
    scales = ctx.act_scales
    keys = [site.id for site, _ in spec.conv_sites]
    if spec.has_downsample:
        keys.append(spec.ds_sites[0].id + ':out')
    if not all(k in scales for k in keys):
        return None
    return [scales[k] for k in keys]


def _block_input(x, scale, ctx):
    """The block input as codes at conv1's frozen scale: codes the previous
    kernel emitted there, or the float input quantized once."""
    if isinstance(x, QTensor):
        return x
    return QTensor(quantize_sym_codes(x, scale, ctx.act_bits), scale)


def _serving_block_input(x, ctx, conv1_site):
    """A block off the int8-resident path (BN live, or a scale it needs
    absent) takes floats: serving with conv1's scale frozen, it quantizes its
    input ONCE and hands the codes to conv1 and the downsample, and the
    identity is their dequantized values (the JAX package's int8-resident
    flow, elementwise).  Returns (x_in, identity)."""
    if isinstance(x, (QTensor, PackedQTensor)):
        raise RuntimeError('a block off the int8-resident path was handed codes')
    if not ctx.int8_serving:
        return x, x
    scale = ctx.act_scales.get(conv1_site.id)
    if scale is None:
        return x, x
    q = QTensor(quantize_sym_codes(x, scale, ctx.act_bits), scale)
    return q, q.dequant(x.dtype)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    planes: int
    stride: int
    in_planes: int
    bottleneck: bool
    fold_bn: bool
    has_downsample: bool
    ds_sites: tuple  # (conv_site, bn_site) or ()
    conv_sites: tuple  # ((conv_site, bn_site), ...) per conv in the block
    dtype: torch.dtype = torch.float32   # the type activations travel in
    groups: int = 1       # ResNeXt cardinality (torchvision Bottleneck)
    base_width: int = 64  # WideResNet width_per_group

    @property
    def out_planes(self) -> int:
        return self.planes * (4 if self.bottleneck else 1)


def _downsample(s: BlockSpec):
    dc, db = s.ds_sites
    mods = [QConv(s.in_planes, s.out_planes, 1, s.stride, 0, use_bias=s.fold_bn, site=dc,
                  out_codes=s.fold_bn, dtype=s.dtype)]
    if not s.fold_bn:
        mods.append(QBatchNorm(s.out_planes, site=db))
    return nn.ModuleList(mods)


class BasicBlock(nn.Module):
    def __init__(self, spec: BlockSpec):
        super().__init__()
        s = self.spec = spec
        (c1, b1), (c2, b2) = s.conv_sites
        # torchvision's module order (each BN right after its conv), which
        # BN folding of a checkpoint relies on
        self.conv1 = QConv(s.in_planes, s.planes, 3, s.stride, 1, use_bias=s.fold_bn, site=c1,
                           dtype=s.dtype)
        if not s.fold_bn:
            self.bn1 = QBatchNorm(s.planes, site=b1)
        self.conv2 = QConv(s.planes, s.planes, 3, 1, 1, use_bias=s.fold_bn, site=c2,
                           dtype=s.dtype)
        if not s.fold_bn:
            self.bn2 = QBatchNorm(s.planes, site=b2)
        if s.has_downsample:
            self.downsample = _downsample(s)

    @traced('layer.BasicBlock')
    def forward(self, x, ctx: TapContext, out_scale=None):
        """``out_scale``: the next block's input scale when it takes codes
        (``ResNet.forward``), or None for a float output."""
        scales = _codes_scales(self.spec, ctx)
        if scales is not None:
            # int8-resident serving: conv1 emits codes at conv2's scale, and
            # conv2 adds the identity codes and emits the next block's input
            q = _block_input(x, scales[0], ctx)
            out = self.conv1(q, ctx, fuse_relu=True, out_spec=('int8', scales[1]))
            identity = q
            if self.spec.has_downsample:
                identity = self.downsample[0](q, ctx, out_spec=('int8', scales[2]))
            return self.conv2(out, ctx, residual=identity, fuse_relu=True,
                              out_spec=None if out_scale is None else ('int8', out_scale))
        fold = self.spec.fold_bn
        x, identity = _serving_block_input(x, ctx, self.spec.conv_sites[0][0])
        out = self.conv1(x, ctx)
        if not fold:
            out = self.bn1(out, ctx)
        out = self.conv2(relu(out), ctx)
        if not fold:
            out = self.bn2(out, ctx)
        if self.spec.has_downsample:
            identity = run_all(self.downsample, x, ctx)
        return relu(out + identity)


class Bottleneck(nn.Module):
    def __init__(self, spec: BlockSpec):
        super().__init__()
        s = self.spec = spec
        width = int(s.planes * (s.base_width / 64.0)) * s.groups
        (c1, b1), (c2, b2), (c3, b3) = s.conv_sites
        fold = s.fold_bn
        self.conv1 = QConv(s.in_planes, width, 1, 1, 0, use_bias=fold, site=c1, dtype=s.dtype)
        if not fold:
            self.bn1 = QBatchNorm(width, site=b1)
        self.conv2 = QConv(width, width, 3, s.stride, 1, groups=s.groups, use_bias=fold, site=c2,
                           dtype=s.dtype)
        if not fold:
            self.bn2 = QBatchNorm(width, site=b2)
        self.conv3 = QConv(width, s.out_planes, 1, 1, 0, use_bias=fold, site=c3, dtype=s.dtype)
        if not fold:
            self.bn3 = QBatchNorm(s.out_planes, site=b3)
        if s.has_downsample:
            self.downsample = _downsample(s)

    @traced('layer.Bottleneck')
    def forward(self, x, ctx: TapContext, out_spec=False, out_scale=None):
        """``out_spec``: in a packed stage ``ResNet`` passes ('packed' |
        'int8', the next block's input scale), or None for the last block
        (float out); False elsewhere.  ``out_scale``: off packed stages, the
        next block's input scale when it takes codes, or None for a float
        output."""
        fold = self.spec.fold_bn
        if out_spec is not False and ctx.packed:
            # W4A4 packed serving (orchestrated by ResNet.forward): conv1,
            # conv3 and the downsample run as int4 GEMMs, conv2 stays the int8
            # conv and emits codes at conv3's frozen scale; the residual
            # identity is added packed inside conv3's epilogue.  Every tensor
            # between convs is int8 codes, every block boundary 4-bit packed.
            scales = ctx.act_scales
            (c1, _), (c2, _), (c3, _) = self.spec.conv_sites
            out = self.conv1(x, ctx, fuse_relu=True, out_spec=('int8', scales[c2.id]),
                             packed=True)
            out = self.conv2(out, ctx, fuse_relu=True, out_spec=('int8', scales[c3.id]))
            identity = x   # packed codes from the previous block
            if self.spec.has_downsample:
                dc = self.spec.ds_sites[0]
                identity = self.downsample[0](
                    x, ctx, out_spec=('packed', scales[dc.id + ':out:packed']), packed=True)
            return self.conv3(out, ctx, residual=identity, fuse_relu=True, out_spec=out_spec,
                              packed=True)
        scales = _codes_scales(self.spec, ctx)
        if scales is not None:
            # int8-resident serving: the same hand-overs in int8 codes through
            # the int8 kernels' epilogues; conv3 adds the identity codes
            q = _block_input(x, scales[0], ctx)
            out = self.conv1(q, ctx, fuse_relu=True, out_spec=('int8', scales[1]))
            out = self.conv2(out, ctx, fuse_relu=True, out_spec=('int8', scales[2]))
            identity = q
            if self.spec.has_downsample:
                identity = self.downsample[0](q, ctx, out_spec=('int8', scales[3]))
            return self.conv3(out, ctx, residual=identity, fuse_relu=True,
                              out_spec=None if out_scale is None else ('int8', out_scale))
        x, identity = _serving_block_input(x, ctx, self.spec.conv_sites[0][0])
        out = self.conv1(x, ctx)
        if not fold:
            out = self.bn1(out, ctx)
        out = self.conv2(relu(out), ctx)
        if not fold:
            out = self.bn2(out, ctx)
        out = self.conv3(relu(out), ctx)
        if not fold:
            out = self.bn3(out, ctx)
        if self.spec.has_downsample:
            identity = run_all(self.downsample, x, ctx)
        return relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, stem_sites: tuple, stage_specs: tuple, avgpool_site: Site,
                 fc_site: Site, fold_bn: bool = True, num_classes: int = 1000,
                 dtype=torch.float32):
        super().__init__()
        conv_site, bn_site, mp_site = stem_sites
        self.fold_bn, self.dtype = fold_bn, dtype
        self.conv1 = QConv(3, 64, 7, 2, 3, use_bias=fold_bn, site=conv_site, dtype=dtype)
        if not fold_bn:
            self.bn1 = QBatchNorm(64, site=bn_site)
        self.maxpool = QMaxPool(3, 2, 1, site=mp_site)
        self.stages = len(stage_specs)
        self.stage_specs = stage_specs
        for li, stage in enumerate(stage_specs):
            block = Bottleneck if stage[0].bottleneck else BasicBlock
            setattr(self, f'layer{li + 1}', nn.ModuleList(block(sp) for sp in stage))
        self.avgpool = QAvgPool(None, 1, site=avgpool_site)
        self.fc = QLinear(stage_specs[-1][-1].out_planes, num_classes, site=fc_site,
                          dtype=dtype)

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        x = self.conv1(x.to(self.dtype), ctx)
        if not self.fold_bn:
            x = self.bn1(x, ctx)
        x = relu(x)
        pk_stages = self._packed_stages(ctx)
        # (1-based stage, block module) along the trunk
        trunk = [(li + 1, blk) for li in range(self.stages)
                 for blk in getattr(self, f'layer{li + 1}')]

        def codes_in(i):
            """The scale block i takes int8 codes at, or None for floats."""
            stage, blk = trunk[i]
            if stage in pk_stages:
                return ctx.act_scales[blk.spec.conv_sites[0][0].id]
            scales = _codes_scales(blk.spec, ctx)
            return None if scales is None else scales[0]

        scale = codes_in(0) if trunk else None
        if scale is not None:
            # serving: quantize the stem output at the first block conv's
            # frozen input scale and max-pool on int8 codes (max commutes
            # with dequant), so the 112x112 stem tensor is pooled at 1 byte
            x = QTensor(quantize_sym_codes(x, scale, ctx.act_bits), scale)
        x = self.maxpool(x, ctx)
        for i, (stage, blk) in enumerate(trunk):
            last = i + 1 == len(trunk)
            if stage not in pk_stages:
                # a packed -> plain boundary arrives as int8 codes (out_spec
                # 'int8' below), never as a PackedQTensor; a plain -> packed
                # one leaves as floats, which the packed block's conv1 and
                # downsample quantize each at its own scale
                if isinstance(x, PackedQTensor):
                    raise RuntimeError('a plain block was handed packed codes')
                plain_next = not last and trunk[i + 1][0] not in pk_stages
                x = blk(x, ctx, out_scale=codes_in(i + 1) if plain_next else None)
                continue
            out_spec = None   # the last block: float out to the avgpool
            if not last and (scale := codes_in(i + 1)) is not None:
                # into a packed block the boundary crosses device memory 4-bit
                # packed; into a plain block as int8 codes (its QTensor input)
                out_spec = ('packed' if trunk[i + 1][0] in pk_stages else 'int8', scale)
            x = blk(x, ctx, out_spec=out_spec)
        x = self.avgpool(x, ctx)
        if x.shape[2:] != (1, 1):
            # the JAX model flattens NHWC (h, w, c); NCHW flattens (c, h, w),
            # the same order only for a 1x1 map
            raise ValueError(f'ResNet head expects a square input (pooled map '
                             f'{tuple(x.shape[2:])})')
        x = self.fc(x.flatten(1), ctx)
        return x.float()

    def _packed_stages(self, ctx) -> tuple:
        """The 1-based stages that run the packed orchestration under ``ctx``.

        W4A4 packed serving is all-or-nothing across the trunk: every block
        must be a BN-folded Bottleneck with group-alignable output channels
        and every frozen scale it needs must be present (block input scales,
        conv2/conv3 input scales, the downsample ':out:packed' scales; the
        latter exist ONLY when ``freeze_serving_scales`` ran with
        ``packed=True``, so int8-grid frozen scales can never engage the
        packed epilogue).  Otherwise the model takes the plain int8-resident
        path everywhere.  ``ctx.packed`` is True (all stages) or a tuple of
        stages ((1,) packs stage 1 only, the rest stay plain)."""
        pk = ctx.packed
        stages = tuple(pk) if isinstance(pk, (tuple, list)) else ((1, 2, 3, 4) if pk else ())
        blocks = [sp for stage in self.stage_specs for sp in stage]
        if not (stages and self.fold_bn
                and all(sp.bottleneck and sp.out_planes % 256 == 0 for sp in blocks)):
            return ()
        need = []
        for sp in blocks:
            need += [site.id for site, _ in sp.conv_sites]
            if sp.has_downsample:
                need.append(sp.ds_sites[0].id + ':out:packed')
        return stages if all(n in ctx.act_scales for n in need) else ()


_LAYER_CFG = {
    # arch: (block kind, stage depths, groups, width_per_group)
    'resnet18': ('basic', (2, 2, 2, 2), 1, 64),
    'resnet34': ('basic', (3, 4, 6, 3), 1, 64),
    'resnet50': ('bottleneck', (3, 4, 6, 3), 1, 64),
    'resnet101': ('bottleneck', (3, 4, 23, 3), 1, 64),
    'resnet152': ('bottleneck', (3, 8, 36, 3), 1, 64),
    'resnext50_32x4d': ('bottleneck', (3, 4, 6, 3), 32, 4),
    'resnext101_32x8d': ('bottleneck', (3, 4, 23, 3), 32, 8),
    'wide_resnet50_2': ('bottleneck', (3, 4, 6, 3), 1, 128),
    'wide_resnet101_2': ('bottleneck', (3, 4, 23, 3), 1, 128),
}


def build_resnet(arch: str, fold_bn: bool = True, num_classes: int = 1000,
                 dtype=torch.float32, mark_relu: bool | None = None) -> ResNet:
    """A ResNet with reference-compatible site numbering (torchvision +
    reference construction order): stem conv/bn first; per stage the
    downsample conv/bn before block 0's convs; before-ReLU half-range marks
    (utils/mark_relu.py:4-29) only when ``'resnet' in arch``."""
    kind, depths, groups, base_width = _LAYER_CFG[arch]
    bottleneck = kind == 'bottleneck'
    expansion = 4 if bottleneck else 1
    if mark_relu is None:
        mark_relu = 'resnet' in arch
    hr = mark_relu
    namer = SiteNamer()

    stem = (namer.conv(half_range=hr), namer.bn(half_range=hr), namer.maxpool())

    in_planes = 64
    stages = []
    for si, depth in enumerate(depths):
        planes = 64 * (2 ** si)
        stride = 1 if si == 0 else 2
        blocks = []
        for bi in range(depth):
            blk_stride = stride if bi == 0 else 1
            has_ds = bi == 0 and (blk_stride != 1 or in_planes != planes * expansion)
            ds_sites = (namer.conv(), namer.bn()) if has_ds else ()
            if bottleneck:
                conv_sites = (
                    (namer.conv(half_range=hr), namer.bn(half_range=hr)),
                    (namer.conv(half_range=hr), namer.bn(half_range=hr)),
                    (namer.conv(), namer.bn()),
                )
            else:
                conv_sites = (
                    (namer.conv(half_range=hr), namer.bn(half_range=hr)),
                    (namer.conv(), namer.bn()),
                )
            blocks.append(BlockSpec(
                planes=planes, stride=blk_stride, in_planes=in_planes,
                bottleneck=bottleneck, fold_bn=fold_bn, has_downsample=has_ds,
                ds_sites=ds_sites, conv_sites=conv_sites, dtype=dtype,
                groups=groups, base_width=base_width))
            in_planes = planes * expansion
        stages.append(tuple(blocks))

    return ResNet(stem_sites=stem, stage_specs=tuple(stages),
                  avgpool_site=namer.avgpool(), fc_site=namer.linear(classifier=True),
                  fold_bn=fold_bn, num_classes=num_classes, dtype=dtype)
