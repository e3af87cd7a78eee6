"""DenseNet 121/161/169/201 (torchvision layout; NCHW in channels_last memory).

Port of ``cnn_quantization_tpu/models/densenet.py``.  The reference neither
BN-folds nor half-range marks DenseNets (no 'resnet' in the name), so every
BN is a live site.  The layers are pre-activation (norm1, ReLU, conv1, norm2,
ReLU, conv2) and the trunk concatenates each layer's 32 (48 for 161) new
channels onto its input along C (channels_last stays channels_last through
``torch.cat``).  Transitions are norm, ReLU, 1x1 conv and a 2x2 average pool
site; the final adaptive average pool is a functional mean in torchvision's
forward, so it is not a site.  Module names are torchvision's
(``features.denseblock1.denselayer1.conv1``, ``features.transition1.conv``,
``features.norm5``, ``classifier``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..engine.context import TapContext
from .layers import QAvgPool, QBatchNorm, QConv, QLinear, QMaxPool, SiteNamer, relu


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth_rate: int, bn_size: int, sites: tuple):
        super().__init__()
        b1, c1, b2, c2 = sites
        width = bn_size * growth_rate
        self.norm1 = QBatchNorm(in_ch, site=b1)
        self.conv1 = QConv(in_ch, width, 1, use_bias=False, site=c1)
        self.norm2 = QBatchNorm(width, site=b2)
        self.conv2 = QConv(width, growth_rate, 3, 1, 1, use_bias=False, site=c2)

    def forward(self, x, ctx: TapContext):
        h = self.conv1(relu(self.norm1(x, ctx)), ctx)
        return self.conv2(relu(self.norm2(h, ctx)), ctx)


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, sites: tuple):
        super().__init__()
        b, c, p = sites
        self.norm = QBatchNorm(in_ch, site=b)
        self.conv = QConv(in_ch, out_ch, 1, use_bias=False, site=c)
        self.pool = QAvgPool(2, 2, site=p)

    def forward(self, x, ctx: TapContext):
        return self.pool(self.conv(relu(self.norm(x, ctx)), ctx), ctx)


class DenseFeatures(nn.Module):
    def __init__(self, block_config: tuple, growth_rate: int, num_init_features: int,
                 bn_size: int, sites: dict):
        super().__init__()
        self.conv0 = QConv(3, num_init_features, 7, 2, 3, use_bias=False, site=sites['conv0'])
        self.norm0 = QBatchNorm(num_init_features, site=sites['norm0'])
        self.pool0 = QMaxPool(3, 2, 1, site=sites['pool0'])
        self.blocks = []   # (1-based block, has a transition), in order
        ch = num_init_features
        for i, n_layers in enumerate(block_config):
            block = nn.Module()
            for j in range(n_layers):
                block.add_module(f'denselayer{j + 1}', DenseLayer(
                    ch + j * growth_rate, growth_rate, bn_size, sites[f'block{i + 1}'][j]))
            self.add_module(f'denseblock{i + 1}', block)
            ch += n_layers * growth_rate
            last = i == len(block_config) - 1
            if not last:
                self.add_module(f'transition{i + 1}',
                                Transition(ch, ch // 2, sites[f'trans{i + 1}']))
                ch //= 2
            self.blocks.append((i + 1, not last))
        self.norm5 = QBatchNorm(ch, site=sites['norm5'])
        self.out_features = ch

    def forward(self, x, ctx: TapContext):
        x = self.pool0(relu(self.norm0(self.conv0(x, ctx), ctx)), ctx)
        for i, has_transition in self.blocks:
            for layer in getattr(self, f'denseblock{i}').children():
                x = torch.cat([x, layer(x, ctx)], 1)
            if has_transition:
                x = getattr(self, f'transition{i}')(x, ctx)
        return self.norm5(x, ctx)


class DenseNet(nn.Module):
    def __init__(self, block_config: tuple, growth_rate: int, num_init_features: int,
                 sites: dict, bn_size: int = 4, num_classes: int = 1000):
        super().__init__()
        self.features = DenseFeatures(block_config, growth_rate, num_init_features, bn_size,
                                      sites)
        self.classifier = QLinear(self.features.out_features, num_classes,
                                  site=sites['classifier'])

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        x = relu(self.features(x, ctx))
        return self.classifier(torch.mean(x, dim=(2, 3)), ctx)   # functional pool: no site


_CFG = {
    # arch: (growth_rate, block_config, num_init_features)
    'densenet121': (32, (6, 12, 24, 16), 64),
    'densenet161': (48, (6, 12, 36, 24), 96),
    'densenet169': (32, (6, 12, 32, 32), 64),
    'densenet201': (32, (6, 12, 48, 32), 64),
}


def build_densenet(arch: str, num_classes: int = 1000) -> DenseNet:
    growth, blocks, init_feat = _CFG[arch]
    n = SiteNamer()
    sites: dict = {'conv0': n.conv(), 'norm0': n.bn(), 'pool0': n.maxpool()}
    for i, n_layers in enumerate(blocks):
        sites[f'block{i + 1}'] = tuple((n.bn(), n.conv(), n.bn(), n.conv())
                                       for _ in range(n_layers))
        if i != len(blocks) - 1:
            sites[f'trans{i + 1}'] = (n.bn(), n.conv(), n.avgpool())
    sites['norm5'] = n.bn()
    sites['classifier'] = n.linear(classifier=True)
    return DenseNet(blocks, growth, init_feat, sites, num_classes=num_classes)
