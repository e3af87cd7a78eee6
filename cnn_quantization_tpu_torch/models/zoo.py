"""Model registry: arch name -> (module, ModelMeta).

Port of ``cnn_quantization_tpu/models/zoo.py`` for the ResNet family (resnet,
resnext, wide_resnet) and MobileNet-v2.  The rest of the zoo (vgg, inception,
googlenet, densenet, shufflenet, squeezenet, alexnet) is ROADMAP Queue 1
item 7.
"""

from __future__ import annotations

import torch

from ..engine.engine import ModelMeta
from ..utils.device import resolve_device, use_full_fp32
from .layers import init_parameters

# archs the reference BN-folds: ``'resnet' in arch`` (inference_sim.py:179-182).
# resnext* does not contain 'resnet', so it is neither folded nor before-ReLU
# marked, while wide_resnet* is both; MobileNet-v2 is not in the rule either
# (``build_mobilenet_v2`` would fold only the groups == 1 convs if asked to).
_FOLDED = ('resnet18', 'resnet34', 'resnet50', 'resnet101', 'resnet152',
           'wide_resnet50_2', 'wide_resnet101_2')

_RESNET_FAMILY = ('resnet18', 'resnet34', 'resnet50', 'resnet101', 'resnet152',
                  'resnext50_32x4d', 'resnext101_32x8d', 'wide_resnet50_2', 'wide_resnet101_2')


def available_archs():
    return _RESNET_FAMILY + ('mobilenet_v2',)


def build_model(arch: str, fold_bn: bool | None = None, num_classes: int = 1000,
                dtype: str = 'float32', *, device=None, seed: int = 0):
    """(model, meta) with seeded He-normal weights on ``device`` (the card
    unless ``device='cpu'``).  ``dtype`` ('float32' or 'bfloat16') is the type
    the ResNet family's activations travel in; parameters stay float32.  The
    model is in eval mode; its forward takes NCHW input and a ``TapContext``."""
    if arch == 'mobilenetv2':
        arch = 'mobilenet_v2'
    if arch not in available_archs():
        raise ValueError(f'arch {arch!r} is not ported (available: '
                         f'{", ".join(available_archs())}); the rest of the zoo is '
                         'ROADMAP Queue 1 item 7')
    if dtype not in ('float32', 'bfloat16'):
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
    dev = resolve_device(device)
    use_full_fp32()
    if fold_bn is None:
        fold_bn = arch in _FOLDED
    if arch == 'mobilenet_v2':
        from .mobilenetv2 import build_mobilenet_v2
        model = build_mobilenet_v2(num_classes, fold_bn=fold_bn)
    else:
        from .resnet import build_resnet
        model = build_resnet(arch, fold_bn=fold_bn, num_classes=num_classes,
                             dtype=getattr(torch, dtype))
    init_parameters(model, seed)
    return model.to(dev).eval(), ModelMeta(arch=arch, fold_bn=fold_bn)
