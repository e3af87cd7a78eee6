"""VGG family (11/13/16/19 and the ``_bn`` variants; NCHW in channels_last
memory).

Port of ``cnn_quantization_tpu/models/vgg.py``: a conv/max-pool feature stack
and the 4096-4096-1000 classifier.  Module names are torchvision's
(``features.N`` counted with the ReLU and BN slots, ``classifier.0/3/6``),
which the weight bridge yields from the JAX names (``features_N``,
``classifier_N``).  These are fused-ReLU architectures in the reference
(force_positive at the policy level), so no site is half-range marked.  The
``_bn`` variants fold BN at load (the registry's rule); unfolded, the BNs are
live sites.  The plain variants have no BN.

Flatten order: the JAX model flattens its NHWC feature map, so its first
classifier kernel runs in (H, W, C) order, and the JAX importer permutes
torchvision checkpoints into that order (``utils/torch_import.py``
``FLATTEN_INPUTS``).  The port flattens in the same (H, W, C) order, the
contiguous order of a channels_last tensor (``x.permute(0, 2, 3, 1)``), so
the weight bridge carries that kernel across unchanged at every input size;
``utils/checkpoint.py`` permutes a torchvision checkpoint as the JAX
importer does.  Like the JAX model there is no adaptive pool ahead of the
classifier: the first classifier's width follows the input size the model is
built for (512 * 7 * 7 at 224x224).
"""

from __future__ import annotations

from torch import nn

from ..engine.context import TapContext
from .layers import QBatchNorm, QConv, QLinear, QMaxPool, ReLU, SiteNamer, Slot, run_all

_CFGS = {
    'vgg11': (64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'),
    'vgg13': (64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'),
    'vgg16': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512, 'M',
              512, 512, 512, 'M'),
    'vgg19': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M', 512, 512, 512, 512,
              'M', 512, 512, 512, 512, 'M'),
}


def flatten_hwc(x):
    """[N, C, H, W] -> [N, H*W*C] in (H, W, C) order, the JAX package's NHWC
    flatten: a view for a channels_last tensor."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class VGG(nn.Module):
    def __init__(self, cfg: tuple, batch_norm: bool, fold_bn: bool, feature_sites: tuple,
                 classifier_sites: tuple, num_classes: int = 1000, input_size: int = 224):
        super().__init__()
        folded = (not batch_norm) or fold_bn
        features, in_ch, size = [], 3, input_size
        for entry, sites in zip(cfg, feature_sites):
            if entry == 'M':
                features.append(QMaxPool(2, 2, site=sites))
                size //= 2
                continue
            conv_site, bn_site = sites
            features.append(QConv(in_ch, entry, 3, 1, 1, use_bias=folded, site=conv_site))
            if batch_norm:
                features.append(Slot() if fold_bn else QBatchNorm(entry, site=bn_site))
            features.append(ReLU())
            in_ch = entry
        self.features = nn.ModuleList(features)
        l0, l1, l2 = classifier_sites
        # torchvision's classifier: Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear
        self.classifier = nn.ModuleList([
            QLinear(in_ch * size * size, 4096, site=l0), ReLU(), Slot(),
            QLinear(4096, 4096, site=l1), ReLU(), Slot(),
            QLinear(4096, num_classes, site=l2)])

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        x = run_all(self.features, x, ctx)
        return run_all(self.classifier, flatten_hwc(x), ctx)


def build_vgg(arch: str, fold_bn: bool = True, num_classes: int = 1000,
              input_size: int = 224) -> VGG:
    base = arch.replace('_bn', '')
    batch_norm = arch.endswith('_bn')
    cfg = _CFGS[base]
    namer = SiteNamer()
    feature_sites = []
    for entry in cfg:
        if entry == 'M':
            feature_sites.append(namer.maxpool())
        else:
            conv_site = namer.conv()
            bn_site = namer.bn() if batch_norm else None
            feature_sites.append((conv_site, bn_site))
    classifier_sites = (namer.linear(), namer.linear(), namer.linear(classifier=True))
    return VGG(cfg, batch_norm, fold_bn, tuple(feature_sites), classifier_sites,
               num_classes=num_classes, input_size=input_size)
