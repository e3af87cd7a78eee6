"""Model registry: arch name -> (module, ModelMeta).

Port of ``cnn_quantization_tpu/models/zoo.py`` for this slice's archs,
resnet18 and resnet50.  The rest of the zoo is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from ..engine.engine import ModelMeta
from ..utils.device import resolve_device, use_full_fp32
from .layers import init_parameters

# archs the reference BN-folds (inference_sim.py:179-182)
_FOLDED = ('resnet18', 'resnet50')


def available_archs():
    return ('resnet18', 'resnet50')


def build_model(arch: str, fold_bn: bool | None = None, num_classes: int = 1000,
                *, device=None, seed: int = 0):
    """(model, meta) with seeded He-normal weights on ``device`` (the card
    unless ``device='cpu'``).  The model is in eval mode; its forward takes
    NCHW input and a ``TapContext``."""
    if arch not in available_archs():
        raise ValueError(f'arch {arch!r} is not ported yet (this slice has '
                         f'{", ".join(available_archs())}); the rest of the zoo is '
                         'ROADMAP Queue 1 item 7')
    dev = resolve_device(device)
    use_full_fp32()
    if fold_bn is None:
        fold_bn = arch in _FOLDED
    from .resnet import build_resnet
    model = build_resnet(arch, fold_bn=fold_bn, num_classes=num_classes)
    init_parameters(model, seed)
    return model.to(dev).eval(), ModelMeta(arch=arch, fold_bn=fold_bn)
