"""MobileNet-v2 (torchvision layout; NCHW in channels_last memory).

Port of ``cnn_quantization_tpu/models/mobilenetv2.py``: the depthwise stress
case for per-channel kernels.  BN folding follows the reference rule
(absorb_bn.py:31): only groups == 1 convs absorb their BN, so with
``fold_bn=True`` the 17 depthwise BNs stay live modules (quantized with tag
'activation') while the expand, project, stem and head BNs fold into their
convs.  Activations are ReLU6.  Module and parameter names are torchvision's
(``features.N.0``, ``features.N.conv.K``, ``classifier.1``), and the site ids
replicate the reference's construction-order numbering (52 convs, one BN id
per conv whether or not it is built).

On the true-int8 serving path every 1x1 conv and the classifier run the int8
GEMM kernel, the depthwise 3x3 convs the grouped path of the int8 conv kernel
with per-channel activation scales (``models/layers.py``), and the in_ch == 3
stem stays a float conv.
"""

from __future__ import annotations

import torch
from torch import nn

from ..engine.context import TapContext
from ..utils.spans import traced
from .layers import QBatchNorm, QConv, QLinear, SiteNamer, run_all


def relu6(x):
    return torch.clamp(x, 0, 6)


def conv_bn(in_ch, features, *, kernel=3, stride=1, groups=1, fold_bn=True, sites=()):
    """torchvision's ``ConvBNReLU`` members as ``[conv]`` or ``[conv, bn]``
    (indices 0 and 1 of the container, as in its state dict)."""
    conv_site, bn_site = sites
    folded = fold_bn and groups == 1
    mods = [QConv(in_ch, features, kernel, stride, (kernel - 1) // 2, groups=groups,
                  use_bias=folded, site=conv_site)]
    if not folded:
        mods.append(QBatchNorm(features, site=bn_site))
    return nn.ModuleList(mods)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int, fold_bn: bool,
                 sites: tuple):
        super().__init__()
        hidden = in_ch * expand
        self.use_res = stride == 1 and in_ch == out_ch
        s = iter(sites)
        conv = []
        if expand != 1:
            conv.append(conv_bn(in_ch, hidden, kernel=1, fold_bn=fold_bn, sites=next(s)))
        conv.append(conv_bn(hidden, hidden, kernel=3, stride=stride, groups=hidden,
                            fold_bn=fold_bn, sites=next(s)))
        self.n_relu = len(conv)   # the ConvBNReLU members; the project conv has no ReLU
        conv_site, bn_site = next(s)
        conv.append(QConv(hidden, out_ch, 1, 1, 0, use_bias=fold_bn, site=conv_site))
        if not fold_bn:
            conv.append(QBatchNorm(out_ch, site=bn_site))
        self.conv = nn.ModuleList(conv)

    @traced('layer.InvertedResidual')
    def forward(self, x, ctx: TapContext):
        out = x
        for i, m in enumerate(self.conv):
            out = relu6(run_all(m, out, ctx)) if i < self.n_relu else m(out, ctx)
        return x + out if self.use_res else out


_CFG = [  # t, c, n, s
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class MobileNetV2(nn.Module):
    def __init__(self, block_specs: tuple, sites: dict, fold_bn: bool = True,
                 num_classes: int = 1000):
        super().__init__()
        features = [conv_bn(3, 32, kernel=3, stride=2, fold_bn=fold_bn, sites=sites['stem'])]
        for in_ch, out_ch, stride, t, block_sites in block_specs:
            features.append(InvertedResidual(in_ch, out_ch, stride, t, fold_bn, block_sites))
        features.append(conv_bn(block_specs[-1][1], 1280, kernel=1, fold_bn=fold_bn,
                                sites=sites['head']))
        self.features = nn.ModuleList(features)
        # torchvision's classifier is Sequential(Dropout, Linear): index 1
        self.classifier = nn.ModuleList([nn.Identity(), QLinear(1280, num_classes,
                                                                site=sites['fc'])])

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        x = relu6(run_all(self.features[0], x, ctx))
        for block in self.features[1:-1]:
            x = block(x, ctx)
        x = relu6(run_all(self.features[-1], x, ctx))
        x = torch.mean(x, dim=(2, 3))
        return self.classifier[1](x, ctx)


def build_mobilenet_v2(num_classes: int = 1000, fold_bn: bool = True) -> MobileNetV2:
    n = SiteNamer()
    sites = {'stem': (n.conv(), n.bn())}
    specs = []
    in_ch = 32
    for t, c, blocks, s in _CFG:
        for b in range(blocks):
            stride = s if b == 0 else 1
            n_convs = 3 if t != 1 else 2
            block_sites = tuple((n.conv(), n.bn()) for _ in range(n_convs))
            specs.append((in_ch, c, stride, t, block_sites))
            in_ch = c
    sites['head'] = (n.conv(), n.bn())
    sites['fc'] = n.linear(classifier=True)
    return MobileNetV2(block_specs=tuple(specs), sites=sites, fold_bn=fold_bn,
                       num_classes=num_classes)
