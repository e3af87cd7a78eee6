"""Model registry: arch name -> (module, ModelMeta).

Port of ``cnn_quantization_tpu/models/zoo.py``: the reference's evaluated zoo
(the ResNet family, VGG, AlexNet, SqueezeNet, Inception-v3, MobileNet-v2,
DenseNet, GoogLeNet and ShuffleNet), the same 25 names.
"""

from __future__ import annotations

import torch

from ..engine.engine import ModelMeta
from ..utils.device import resolve_device, use_full_fp32
from .layers import init_parameters

# archs the reference BN-folds: ``'resnet' in arch or vgg16_bn or
# inception_v3`` (inference_sim.py:179-182).  resnext* does not contain
# 'resnet', so it is neither folded nor before-ReLU marked, while wide_resnet*
# is both.  MobileNet-v2, DenseNet, GoogLeNet and ShuffleNet keep live BNs.
_FOLDED = ('resnet18', 'resnet34', 'resnet50', 'resnet101', 'resnet152',
           'wide_resnet50_2', 'wide_resnet101_2',
           'vgg16_bn', 'vgg11_bn', 'vgg13_bn', 'vgg19_bn', 'inception_v3')

_RESNET_FAMILY = ('resnet18', 'resnet34', 'resnet50', 'resnet101', 'resnet152',
                  'resnext50_32x4d', 'resnext101_32x8d', 'wide_resnet50_2', 'wide_resnet101_2')

_ARCHS = _RESNET_FAMILY + (
    'vgg11', 'vgg13', 'vgg16', 'vgg19', 'vgg16_bn', 'alexnet',
    'squeezenet1_0', 'squeezenet1_1', 'inception_v3', 'mobilenet_v2',
    'densenet121', 'densenet161', 'densenet169', 'densenet201',
    'googlenet', 'shufflenet')

# archs with a BN per conv but no folding option in the JAX package: their
# meta says unfolded whatever ``fold_bn`` asks
_ALWAYS_UNFOLDED = ('densenet121', 'densenet161', 'densenet169', 'densenet201',
                    'googlenet', 'shufflenet', 'alexnet', 'squeezenet1_0', 'squeezenet1_1')


def available_archs():
    return _ARCHS


def _build(arch: str, fold_bn: bool, num_classes: int, dtype, input_size: int):
    if arch in _RESNET_FAMILY:
        from .resnet import build_resnet
        return build_resnet(arch, fold_bn=fold_bn, num_classes=num_classes, dtype=dtype)
    if arch == 'mobilenet_v2':
        from .mobilenetv2 import build_mobilenet_v2
        return build_mobilenet_v2(num_classes, fold_bn=fold_bn)
    if arch.startswith('vgg'):
        from .vgg import build_vgg
        return build_vgg(arch, fold_bn=fold_bn, num_classes=num_classes, input_size=input_size)
    if arch == 'alexnet':
        from .alexnet import build_alexnet
        return build_alexnet(num_classes, input_size=input_size)
    if arch.startswith('squeezenet'):
        from .squeezenet import build_squeezenet
        return build_squeezenet(arch, num_classes)
    if arch == 'inception_v3':
        from .inception import build_inception_v3
        return build_inception_v3(num_classes, fold_bn=fold_bn)
    if arch.startswith('densenet'):
        from .densenet import build_densenet
        return build_densenet(arch, num_classes)
    if arch == 'googlenet':
        from .googlenet import build_googlenet
        return build_googlenet(num_classes)
    from .shufflenet import build_shufflenet
    return build_shufflenet(groups=8, num_classes=num_classes)


def build_model(arch: str, fold_bn: bool | None = None, num_classes: int = 1000,
                dtype: str = 'float32', *, device=None, seed: int = 0,
                input_size: int | None = None):
    """(model, meta) with seeded He-normal weights on ``device`` (the card
    unless ``device='cpu'``).  ``dtype`` ('float32' or 'bfloat16') is the type
    the ResNet family's activations travel in; parameters stay float32.
    ``input_size`` is the square input the model is built for (default the
    arch's: 299 for Inception-v3, else 224): VGG and AlexNet flatten their
    feature map, so it sets their first classifier's width; ``meta.input_size``
    reports it.  The model is in eval mode; its forward takes NCHW input and a
    ``TapContext``."""
    if arch == 'mobilenetv2':
        arch = 'mobilenet_v2'
    if arch not in available_archs():
        raise ValueError(f'unknown arch {arch!r} (available: {", ".join(available_archs())})')
    if dtype not in ('float32', 'bfloat16'):
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
    dev = resolve_device(device)
    use_full_fp32()
    if fold_bn is None:
        fold_bn = arch in _FOLDED
    if arch in _ALWAYS_UNFOLDED:
        fold_bn = False
    size = input_size or (299 if arch == 'inception_v3' else 224)
    model = _build(arch, fold_bn, num_classes, getattr(torch, dtype), size)
    if dev.type != 'meta':   # a meta model holds no values to draw
        init_parameters(model, seed)
    eight_bit = ('Conv2d_1a_3x3', 'Conv2d_2a_3x3') if arch == 'inception_v3' else ()
    return model.to(dev).eval(), ModelMeta(arch=arch, fold_bn=fold_bn, input_size=size,
                                           eight_bit_weight_names=eight_bit)
