"""ShuffleNet v1, groups = 8 (NCHW in channels_last memory).

Port of ``cnn_quantization_tpu/models/shufflenet.py``; the reference
evaluates a user-supplied ShuffleNet(groups=8) checkpoint.  Grouped and
depthwise convs keep their BNs live (the reference folds groups == 1 convs
only), so this architecture runs unfolded.  A unit is a grouped 1x1 conv
(groups = 1 for stage 2's first unit, whose input has 24 channels), BN, ReLU,
the channel shuffle, a depthwise 3x3, BN, a grouped 1x1 conv and BN; a
stride-2 unit concatenates a 3x3 average-pool shortcut site ahead of its
branch, the others add their input.  On the serving path a grouped conv's
activation scale is a per-group ``[in_ch]`` vector in the conv's own input
channel order (after the shuffle), and the depthwise 3x3 a per-channel one.
Module names are the JAX package's (``stage_N`` split by the weight bridge
into ``stage.N``; ``gconv1``, ``dwconv``, ``gconv3``, ``bn1``-``bn3``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..engine.context import TapContext
from .layers import QAvgPool, QBatchNorm, QConv, QLinear, QMaxPool, SiteNamer, relu

# output channels per stage for each group count (ShuffleNet v1 table 1)
_STAGE_OUT = {1: (144, 288, 576), 2: (200, 400, 800), 3: (240, 480, 960),
              4: (272, 544, 1088), 8: (384, 768, 1536)}
_REPEATS = (3, 7, 3)


def channel_shuffle(x, groups: int):
    """Channel c = g * (C/groups) + i moves to i * groups + g, as the JAX
    package shuffles its NHWC tensor; the result is channels_last."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return y.reshape(n, h, w, c).permute(0, 3, 1, 2)


class ShuffleUnit(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, stride: int, first_group: bool,
                 sites: tuple):
        super().__init__()
        self.groups, self.stride = groups, stride
        bottleneck = out_ch // 4
        (c1, b1), (c2, b2), (c3, b3) = sites[:3]
        branch_out = out_ch - in_ch if stride > 1 else out_ch
        self.gconv1 = QConv(in_ch, bottleneck, 1, groups=1 if first_group else groups,
                            use_bias=False, site=c1)
        self.bn1 = QBatchNorm(bottleneck, site=b1)
        self.dwconv = QConv(bottleneck, bottleneck, 3, stride, 1, groups=bottleneck,
                            use_bias=False, site=c2)
        self.bn2 = QBatchNorm(bottleneck, site=b2)
        self.gconv3 = QConv(bottleneck, branch_out, 1, groups=groups, use_bias=False, site=c3)
        self.bn3 = QBatchNorm(branch_out, site=b3)
        if stride > 1:
            self.shortcut_pool = QAvgPool(3, 2, 1, site=sites[3])

    def forward(self, x, ctx: TapContext):
        out = relu(self.bn1(self.gconv1(x, ctx), ctx))
        out = self.bn2(self.dwconv(channel_shuffle(out, self.groups), ctx), ctx)
        out = self.bn3(self.gconv3(out, ctx), ctx)
        if self.stride > 1:
            return relu(torch.cat([self.shortcut_pool(x, ctx), out], 1))
        return relu(x + out)


class ShuffleNet(nn.Module):
    def __init__(self, groups: int, sites: dict, unit_specs: tuple, num_classes: int = 1000):
        super().__init__()
        c0, b0 = sites['stem']
        self.conv1 = QConv(3, 24, 3, 2, 1, use_bias=False, site=c0)
        self.bn1 = QBatchNorm(24, site=b0)
        self.maxpool = QMaxPool(3, 2, 1, site=sites['maxpool'])
        units, in_ch = [], 24
        for out_ch, stride, first_group, unit_sites in unit_specs:
            units.append(ShuffleUnit(in_ch, out_ch, groups, stride, first_group, unit_sites))
            in_ch = out_ch
        self.stage = nn.ModuleList(units)
        self.fc = QLinear(in_ch, num_classes, site=sites['fc'])

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        x = self.maxpool(relu(self.bn1(self.conv1(x, ctx), ctx)), ctx)
        for unit in self.stage:
            x = unit(x, ctx)
        return self.fc(torch.mean(x, dim=(2, 3)), ctx)


def build_shufflenet(groups: int = 8, num_classes: int = 1000) -> ShuffleNet:
    n = SiteNamer()
    sites = {'stem': (n.conv(), n.bn()), 'maxpool': n.maxpool()}
    specs = []
    for si, (out_ch, reps) in enumerate(zip(_STAGE_OUT[groups], _REPEATS)):
        specs.append((out_ch, 2, si == 0,
                      tuple([(n.conv(), n.bn()) for _ in range(3)] + [n.avgpool()])))
        for _ in range(reps):
            specs.append((out_ch, 1, False, tuple((n.conv(), n.bn()) for _ in range(3))))
    sites['fc'] = n.linear(classifier=True)
    return ShuffleNet(groups, sites, tuple(specs), num_classes=num_classes)
