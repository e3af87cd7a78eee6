"""Inception-v3 (torchvision layout; NCHW in channels_last memory).

Port of ``cnn_quantization_tpu/models/inception.py``:

  * the pools are functional (``F.max_pool2d`` / ``F.avg_pool2d`` in
    torchvision's ``Inception3``), so this architecture has no pool sites;
  * the aux tower (conv0, conv1, fc) is constructed between Mixed_6e and
    Mixed_7a in torchvision and consumes two conv ids and linear0, so the conv
    ids reach 95 while 94 convs run, and the classifier is
    ``linear1_activation``; the tower is never built or run here;
  * a fused-ReLU architecture (force_positive at the policy level);
  * BN eps is 1e-3 (``BasicConv2d``), folded at load by default;
  * the first two stem convs keep 8-bit weights by name
    (``ModelMeta.eight_bit_weight_names`` = ``Conv2d_1a_3x3``,
    ``Conv2d_2a_3x3``, matched as substrings of the module paths);
  * the 1x7/7x1 and 1x3/3x1 filters pad asymmetrically ((0, 3), (3, 0),
    (0, 1), (1, 0)); on the serving path they take the int8 conv's TMA
    im2col route where C is a multiple of 64;
  * ``transform_input`` renormalizes the input as the pretrained model does.

Module names are torchvision's own (``Mixed_5b.branch5x5_1.conv``,
``Mixed_7a.branch7x7x3_4.conv``): their ``_<digits>`` are part of the name,
so the weight bridge splits nothing for this architecture.  The input is
299x299 (``ModelMeta.input_size``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..engine.context import TapContext
from .googlenet import BasicConv2d, transform_input
from .layers import QLinear, SiteNamer


def _avg_pool(x):
    """The branch pools: 3x3, stride 1, padding 1, the padding counted (torch's
    default count_include_pad)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class _Mixed(nn.Module):
    """A block of named ``BasicConv2d`` branches; ``specs`` is (name, in_ch,
    out_ch, kernel, stride, padding) per conv, in construction order."""

    def __init__(self, specs, fold_bn: bool, sites: tuple):
        super().__init__()
        for (name, cin, cout, k, s, p), site in zip(specs, sites):
            self.add_module(name, BasicConv2d(cin, cout, k, s, p, sites=site, fold_bn=fold_bn))


class InceptionA(_Mixed):
    def __init__(self, in_ch: int, pool_features: int, fold_bn: bool, sites: tuple):
        super().__init__((('branch1x1', in_ch, 64, 1, 1, 0),
                          ('branch5x5_1', in_ch, 48, 1, 1, 0),
                          ('branch5x5_2', 48, 64, 5, 1, 2),
                          ('branch3x3dbl_1', in_ch, 64, 1, 1, 0),
                          ('branch3x3dbl_2', 64, 96, 3, 1, 1),
                          ('branch3x3dbl_3', 96, 96, 3, 1, 1),
                          ('branch_pool', in_ch, pool_features, 1, 1, 0)), fold_bn, sites)
        self.out_ch = 64 + 64 + 96 + pool_features

    def forward(self, x, ctx: TapContext):
        b1 = self.branch1x1(x, ctx)
        b5 = self.branch5x5_2(self.branch5x5_1(x, ctx), ctx)
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x, ctx), ctx), ctx)
        bp = self.branch_pool(_avg_pool(x), ctx)
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(_Mixed):
    def __init__(self, in_ch: int, fold_bn: bool, sites: tuple):
        super().__init__((('branch3x3', in_ch, 384, 3, 2, 0),
                          ('branch3x3dbl_1', in_ch, 64, 1, 1, 0),
                          ('branch3x3dbl_2', 64, 96, 3, 1, 1),
                          ('branch3x3dbl_3', 96, 96, 3, 2, 0)), fold_bn, sites)
        self.out_ch = 384 + 96 + in_ch

    def forward(self, x, ctx: TapContext):
        b3 = self.branch3x3(x, ctx)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x, ctx), ctx), ctx)
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(_Mixed):
    def __init__(self, in_ch: int, c7: int, fold_bn: bool, sites: tuple):
        super().__init__((('branch1x1', in_ch, 192, 1, 1, 0),
                          ('branch7x7_1', in_ch, c7, 1, 1, 0),
                          ('branch7x7_2', c7, c7, (1, 7), 1, (0, 3)),
                          ('branch7x7_3', c7, 192, (7, 1), 1, (3, 0)),
                          ('branch7x7dbl_1', in_ch, c7, 1, 1, 0),
                          ('branch7x7dbl_2', c7, c7, (7, 1), 1, (3, 0)),
                          ('branch7x7dbl_3', c7, c7, (1, 7), 1, (0, 3)),
                          ('branch7x7dbl_4', c7, c7, (7, 1), 1, (3, 0)),
                          ('branch7x7dbl_5', c7, 192, (1, 7), 1, (0, 3)),
                          ('branch_pool', in_ch, 192, 1, 1, 0)), fold_bn, sites)
        self.out_ch = 4 * 192

    def forward(self, x, ctx: TapContext):
        b1 = self.branch1x1(x, ctx)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x, ctx), ctx), ctx)
        bd = self.branch7x7dbl_1(x, ctx)
        for i in range(2, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd, ctx)
        bp = self.branch_pool(_avg_pool(x), ctx)
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(_Mixed):
    def __init__(self, in_ch: int, fold_bn: bool, sites: tuple):
        super().__init__((('branch3x3_1', in_ch, 192, 1, 1, 0),
                          ('branch3x3_2', 192, 320, 3, 2, 0),
                          ('branch7x7x3_1', in_ch, 192, 1, 1, 0),
                          ('branch7x7x3_2', 192, 192, (1, 7), 1, (0, 3)),
                          ('branch7x7x3_3', 192, 192, (7, 1), 1, (3, 0)),
                          ('branch7x7x3_4', 192, 192, 3, 2, 0)), fold_bn, sites)
        self.out_ch = 320 + 192 + in_ch

    def forward(self, x, ctx: TapContext):
        b3 = self.branch3x3_2(self.branch3x3_1(x, ctx), ctx)
        b7 = self.branch7x7x3_1(x, ctx)
        for i in range(2, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7, ctx)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(_Mixed):
    def __init__(self, in_ch: int, fold_bn: bool, sites: tuple):
        super().__init__((('branch1x1', in_ch, 320, 1, 1, 0),
                          ('branch3x3_1', in_ch, 384, 1, 1, 0),
                          ('branch3x3_2a', 384, 384, (1, 3), 1, (0, 1)),
                          ('branch3x3_2b', 384, 384, (3, 1), 1, (1, 0)),
                          ('branch3x3dbl_1', in_ch, 448, 1, 1, 0),
                          ('branch3x3dbl_2', 448, 384, 3, 1, 1),
                          ('branch3x3dbl_3a', 384, 384, (1, 3), 1, (0, 1)),
                          ('branch3x3dbl_3b', 384, 384, (3, 1), 1, (1, 0)),
                          ('branch_pool', in_ch, 192, 1, 1, 0)), fold_bn, sites)
        self.out_ch = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x, ctx: TapContext):
        b1 = self.branch1x1(x, ctx)
        b3 = self.branch3x3_1(x, ctx)
        b3 = torch.cat([self.branch3x3_2a(b3, ctx), self.branch3x3_2b(b3, ctx)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x, ctx), ctx)
        bd = torch.cat([self.branch3x3dbl_3a(bd, ctx), self.branch3x3dbl_3b(bd, ctx)], 1)
        bp = self.branch_pool(_avg_pool(x), ctx)
        return torch.cat([b1, b3, bd, bp], 1)


_STEM = (  # name, in_ch, out_ch, kernel, stride, padding; a max pool after 2b and 4a
    ('Conv2d_1a_3x3', 3, 32, 3, 2, 0), ('Conv2d_2a_3x3', 32, 32, 3, 1, 0),
    ('Conv2d_2b_3x3', 32, 64, 3, 1, 1), ('Conv2d_3b_1x1', 64, 80, 1, 1, 0),
    ('Conv2d_4a_3x3', 80, 192, 3, 1, 0))
_MIXED = (  # name, block class, its arguments after in_ch
    ('Mixed_5b', InceptionA, (32,)), ('Mixed_5c', InceptionA, (64,)),
    ('Mixed_5d', InceptionA, (64,)), ('Mixed_6a', InceptionB, ()),
    ('Mixed_6b', InceptionC, (128,)), ('Mixed_6c', InceptionC, (160,)),
    ('Mixed_6d', InceptionC, (160,)), ('Mixed_6e', InceptionC, (192,)),
    ('Mixed_7a', InceptionD, ()), ('Mixed_7b', InceptionE, ()), ('Mixed_7c', InceptionE, ()))


class Inception3(nn.Module):
    def __init__(self, sites: dict, fold_bn: bool = True, num_classes: int = 1000,
                 transform_input: bool = True):
        super().__init__()
        self.transform_input = transform_input
        for name, cin, cout, k, s, p in _STEM:
            self.add_module(name, BasicConv2d(cin, cout, k, s, p, sites=sites[name],
                                              fold_bn=fold_bn))
        in_ch = 192
        for name, block, args in _MIXED:
            mod = block(in_ch, *args, fold_bn, sites[name])
            self.add_module(name, mod)
            in_ch = mod.out_ch
        self.fc = QLinear(in_ch, num_classes, site=sites['fc'])

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        if self.transform_input:
            x = transform_input(x)
        for name, *_ in _STEM:
            x = getattr(self, name)(x, ctx)
            if name in ('Conv2d_2b_3x3', 'Conv2d_4a_3x3'):
                x = _max_pool(x)
        for name, _, _ in _MIXED:   # the aux tower after Mixed_6e never runs
            x = getattr(self, name)(x, ctx)
        return self.fc(torch.mean(x, dim=(2, 3)), ctx)   # functional pool: no site


def build_inception_v3(num_classes: int = 1000, fold_bn: bool = True,
                       transform_input: bool = True) -> Inception3:
    n = SiteNamer()

    def bc():
        return (n.conv(), n.bn())

    convs = {'Mixed_5b': 7, 'Mixed_5c': 7, 'Mixed_5d': 7, 'Mixed_6a': 4, 'Mixed_6b': 10,
             'Mixed_6c': 10, 'Mixed_6d': 10, 'Mixed_6e': 10, 'Mixed_7a': 6, 'Mixed_7b': 9,
             'Mixed_7c': 9}
    sites: dict = {name: bc() for name, *_ in _STEM}
    for name, _, _ in _MIXED:
        if name == 'Mixed_7a':
            # the aux tower is constructed here: conv0, conv1 and fc consume ids
            bc()
            bc()
            n.linear(classifier=True)
        sites[name] = tuple(bc() for _ in range(convs[name]))
    sites['fc'] = n.linear(classifier=True)
    return Inception3(sites, fold_bn=fold_bn, num_classes=num_classes,
                      transform_input=transform_input)
