"""SqueezeNet 1.0 / 1.1 (torchvision layout; NCHW in channels_last memory).

Port of ``cnn_quantization_tpu/models/squeezenet.py``.  A fused-ReLU
architecture in the reference ('squeezenet' in the arch name) with no BN.
Fire modules (``features.N.squeeze``, ``.expand1x1``, ``.expand3x3``)
concatenate their two expand branches along the channels; the max pools use
``ceil_mode=True``.  The classifier is a 1x1 **conv** with 1000 outputs
(``classifier.1``, its site tagged classifier), then a ReLU and a global
average pool site (tagged 'default', as every avgpool site; JAX
``squeezenet.py`` builds it with ``avgpool(classifier=True)``).
On the serving path that conv is an int8 GEMM with N = 1000.
"""

from __future__ import annotations

import torch
from torch import nn

from ..engine.context import TapContext
from .layers import QConv, QGlobalAvgPool, QMaxPool, ReLU, SiteNamer, Slot, relu, run_all


class Fire(nn.Module):
    def __init__(self, in_ch: int, squeeze: int, expand1: int, expand3: int, sites: tuple):
        super().__init__()
        s, e1, e3 = sites
        self.squeeze = QConv(in_ch, squeeze, 1, site=s)
        self.expand1x1 = QConv(squeeze, expand1, 1, site=e1)
        self.expand3x3 = QConv(squeeze, expand3, 3, 1, 1, site=e3)

    def forward(self, x, ctx: TapContext):
        x = relu(self.squeeze(x, ctx))
        return torch.cat([relu(self.expand1x1(x, ctx)), relu(self.expand3x3(x, ctx))], 1)


_FIRE_CFG = {
    # stem (features, kernel, stride, padding); stages of (pool window, fires)
    'squeezenet1_0': dict(
        stem=(96, 7, 2, 0),
        stages=[(3, [(16, 64, 64), (16, 64, 64), (32, 128, 128)]),
                (3, [(32, 128, 128), (48, 192, 192), (48, 192, 192), (64, 256, 256)]),
                (3, [(64, 256, 256)])]),
    'squeezenet1_1': dict(
        stem=(64, 3, 2, 0),
        stages=[(3, [(16, 64, 64), (16, 64, 64)]),
                (3, [(32, 128, 128), (32, 128, 128)]),
                (3, [(48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256)])]),
}


class SqueezeNet(nn.Module):
    def __init__(self, cfg: dict, sites: tuple, num_classes: int = 1000):
        super().__init__()
        stem_site, fire_sites, pool_sites, cls_site, gap_site = sites
        feats, k, s, p = cfg['stem']
        features = [QConv(3, feats, k, s, p, site=stem_site), ReLU()]
        in_ch, fi = feats, 0
        for pi, (pool_k, fires) in enumerate(cfg['stages']):
            features.append(QMaxPool(pool_k, 2, ceil_mode=True, site=pool_sites[pi]))
            for sq, e1, e3 in fires:
                features.append(Fire(in_ch, sq, e1, e3, fire_sites[fi]))
                in_ch, fi = e1 + e3, fi + 1
        self.features = nn.ModuleList(features)
        # torchvision's classifier: Dropout, Conv2d, ReLU, AdaptiveAvgPool2d
        self.classifier = nn.ModuleList([Slot(), QConv(in_ch, num_classes, 1, site=cls_site),
                                         ReLU()])
        self.avgpool = QGlobalAvgPool(site=gap_site)

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        x = run_all(self.classifier, run_all(self.features, x, ctx), ctx)
        return self.avgpool(x, ctx).flatten(1)


def build_squeezenet(arch: str = 'squeezenet1_0', num_classes: int = 1000) -> SqueezeNet:
    cfg = _FIRE_CFG[arch]
    n = SiteNamer()
    stem_site = n.conv()
    fire_sites, pool_sites = [], []
    for _pool_k, fires in cfg['stages']:
        pool_sites.append(n.maxpool())
        for _ in fires:
            fire_sites.append((n.conv(), n.conv(), n.conv()))
    cls_site = n.conv(classifier=True)
    gap_site = n.avgpool(classifier=True)
    return SqueezeNet(cfg, (stem_site, tuple(fire_sites), tuple(pool_sites), cls_site, gap_site),
                      num_classes=num_classes)
