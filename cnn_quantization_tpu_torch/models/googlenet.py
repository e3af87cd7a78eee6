"""GoogLeNet / Inception-v1 (torchvision layout; NCHW in channels_last memory).

Port of ``cnn_quantization_tpu/models/googlenet.py``.  The reference neither
BN-folds nor half-range marks GoogLeNet, so its BNs (eps 1e-3, in
``BasicConv2d``) are live sites.  torchvision's pretrained GoogLeNet always
constructs its two aux towers and then drops them, so they consume conv and
BN ids and linear0..3 at construction but are never built or run here: the
classifier is ``linear4_activation``.  The max pools (four ``ceil_mode`` ones
on the trunk and one a module, ``branch4.0``) are sites; the final adaptive
average pool is not.  ``transform_input`` renormalizes the input as the
pretrained model does.  Module names are torchvision's (``conv1.conv``,
``inception3a.branch2.0.bn``, ``fc``); its "5x5" branch is a 3x3 conv, a
torchvision quirk kept for checkpoint compatibility.
"""

from __future__ import annotations

import torch
from torch import nn

from ..engine.context import TapContext
from .layers import QBatchNorm, QConv, QLinear, QMaxPool, SiteNamer, relu, run_all

# torchvision's transform_input: x * (std / 0.5) + (mean - 0.5) / 0.5 per channel
_TRANSFORM_SCALE = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
_TRANSFORM_SHIFT = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)


def transform_input(x):
    """torchvision's pretrained input renormalization, channel by channel (an
    elementwise affine, so the channels_last layout is kept)."""
    scale = x.new_tensor(_TRANSFORM_SCALE).view(1, 3, 1, 1)
    shift = x.new_tensor(_TRANSFORM_SHIFT).view(1, 3, 1, 1)
    return x * scale + shift


class BasicConv2d(nn.Module):
    """conv (no bias) + BN + ReLU; with ``fold_bn`` the conv carries the
    folded BN as its bias and no BN module is built."""

    def __init__(self, in_ch: int, features: int, kernel_size, strides=1, padding=0, *,
                 sites: tuple, eps: float = 1e-3, fold_bn: bool = False):
        super().__init__()
        conv_site, bn_site = sites
        self.conv = QConv(in_ch, features, kernel_size, strides, padding, use_bias=fold_bn,
                          site=conv_site)
        if not fold_bn:
            self.bn = QBatchNorm(features, eps=eps, site=bn_site)

    def forward(self, x, ctx: TapContext):
        x = self.conv(x, ctx)
        if hasattr(self, 'bn'):
            x = self.bn(x, ctx)
        return relu(x)


class Inception(nn.Module):
    def __init__(self, in_ch: int, ch1x1: int, ch3x3red: int, ch3x3: int, ch5x5red: int,
                 ch5x5: int, pool_proj: int, sites: tuple):
        super().__init__()
        s = iter(sites)
        self.branch1 = BasicConv2d(in_ch, ch1x1, 1, sites=next(s))
        self.branch2 = nn.ModuleList([BasicConv2d(in_ch, ch3x3red, 1, sites=next(s)),
                                      BasicConv2d(ch3x3red, ch3x3, 3, 1, 1, sites=next(s))])
        self.branch3 = nn.ModuleList([BasicConv2d(in_ch, ch5x5red, 1, sites=next(s)),
                                      BasicConv2d(ch5x5red, ch5x5, 3, 1, 1, sites=next(s))])
        self.branch4 = nn.ModuleList([QMaxPool(3, 1, 1, ceil_mode=True, site=next(s)),
                                      BasicConv2d(in_ch, pool_proj, 1, sites=next(s))])
        self.out_ch = ch1x1 + ch3x3 + ch5x5 + pool_proj

    def forward(self, x, ctx: TapContext):
        return torch.cat([self.branch1(x, ctx), run_all(self.branch2, x, ctx),
                          run_all(self.branch3, x, ctx), run_all(self.branch4, x, ctx)], 1)


_INCEPTIONS = (  # name, (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj)
    ('3a', (64, 96, 128, 16, 32, 32)), ('3b', (128, 128, 192, 32, 96, 64)),
    ('4a', (192, 96, 208, 16, 48, 64)), ('4b', (160, 112, 224, 24, 64, 64)),
    ('4c', (128, 128, 256, 24, 64, 64)), ('4d', (112, 144, 288, 32, 64, 64)),
    ('4e', (256, 160, 320, 32, 128, 128)),
    ('5a', (256, 160, 320, 32, 128, 128)), ('5b', (384, 192, 384, 48, 128, 128)),
)
# the trunk's ceil_mode max pools, after the named module: (window, stride)
_POOLS = {'conv3': ('maxpool2', 3), '3b': ('maxpool3', 3), '4e': ('maxpool4', 2)}


class GoogLeNet(nn.Module):
    def __init__(self, sites: dict, num_classes: int = 1000, transform_input: bool = True):
        super().__init__()
        self.transform_input = transform_input
        self.conv1 = BasicConv2d(3, 64, 7, 2, 3, sites=sites['conv1'])
        self.maxpool1 = QMaxPool(3, 2, ceil_mode=True, site=sites['maxpool1'])
        self.conv2 = BasicConv2d(64, 64, 1, sites=sites['conv2'])
        self.conv3 = BasicConv2d(64, 192, 3, 1, 1, sites=sites['conv3'])
        self.maxpool2 = QMaxPool(3, 2, ceil_mode=True, site=sites['maxpool2'])
        in_ch = 192
        for key, cfg in _INCEPTIONS:
            mod = Inception(in_ch, *cfg, sites=sites[key])
            self.add_module(f'inception{key}', mod)
            in_ch = mod.out_ch
            if key in _POOLS:
                name, window = _POOLS[key]
                self.add_module(name, QMaxPool(window, 2, ceil_mode=True, site=sites[name]))
        self.fc = QLinear(in_ch, num_classes, site=sites['fc'])

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        if self.transform_input:
            x = transform_input(x)
        x = self.maxpool1(self.conv1(x, ctx), ctx)
        x = self.maxpool2(self.conv3(self.conv2(x, ctx), ctx), ctx)
        for key, _ in _INCEPTIONS:
            x = getattr(self, f'inception{key}')(x, ctx)
            if key in _POOLS:
                x = getattr(self, _POOLS[key][0])(x, ctx)
        # the aux towers are never run; AdaptiveAvgPool2d is not a site
        return self.fc(torch.mean(x, dim=(2, 3)), ctx)


def build_googlenet(num_classes: int = 1000, transform_input: bool = True) -> GoogLeNet:
    n = SiteNamer()

    def bc():
        return (n.conv(), n.bn())

    sites: dict = {'conv1': bc(), 'maxpool1': n.maxpool(), 'conv2': bc(), 'conv3': bc(),
                   'maxpool2': n.maxpool()}
    for key, _ in _INCEPTIONS:
        sites[key] = (bc(), bc(), bc(), bc(), bc(), n.maxpool(), bc())
        if key in _POOLS:
            sites[_POOLS[key][0]] = n.maxpool()
    # aux1/aux2 (conv + bn, fc1, fc2 each) consume conv/bn ids and linear0..3
    for _ in range(2):
        bc()
        n.linear()
        n.linear()
    sites['fc'] = n.linear(classifier=True)
    return GoogLeNet(sites, num_classes=num_classes, transform_input=transform_input)
