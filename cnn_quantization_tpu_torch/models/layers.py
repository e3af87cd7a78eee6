"""Layer primitives with quantization tap sites (NCHW, OIHW).

Port of the float/simulation branches of ``cnn_quantization_tpu/models/
layers.py`` (the reference's ``*WithId`` intercepting layers,
inference_quantization_manager.py:28-283).  Each layer carries a static
``Site`` and calls the explicit ``TapContext`` on its output.  Activations are
logical NCHW (channels_last in memory), conv weights OIHW, linear weights
[out, in].  Float convs stay ``F.conv2d`` and float linears ``F.linear``, as
the JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..engine.context import Site, TapContext


class SiteNamer:
    """Construction-order id counters mirroring the reference's
    ``itertools.count`` class attributes, so site ids such as
    ``conv12_activation`` match the reference's layer numbering."""

    def __init__(self):
        self.counters: dict[str, int] = {}

    def next(self, kind: str) -> int:
        i = self.counters.get(kind, 0)
        self.counters[kind] = i + 1
        return i

    def conv(self, half_range: bool = False, classifier: bool = False) -> Site:
        i = self.next('conv')
        tag = 'activation_classifier' if classifier else 'activation'
        return Site(id=f'conv{i}_activation', tag=tag, half_range=half_range, kind='conv')

    def bn(self, half_range: bool = False) -> Site:
        i = self.next('bn')
        return Site(id=f'bn{i}_activation', tag='activation', half_range=half_range, kind='bn')

    def linear(self, classifier: bool = False, half_range: bool = False) -> Site:
        i = self.next('linear')
        tag = 'activation_classifier' if classifier else 'activation_linear'
        return Site(id=f'linear{i}_activation', tag=tag,
                    half_range=half_range and not classifier, kind='linear')

    def maxpool(self) -> Site:
        i = self.next('maxpool')
        return Site(id=f'maxpool{i}_out', tag='activation_pooling', kind='maxpool')

    def avgpool(self, classifier: bool = False) -> Site:
        """AvgPool2dWithId passes its tag positionally as the ``id`` argument
        of quantize_instant (inference_quantization_manager.py:95-99), so the
        reference quantizes avgpool outputs with the *default* int8 quantizer;
        the 'default' tag mirrors that quirk (see engine/policy.py)."""
        i = self.next('avgpool')
        return Site(id=f'avgpool{i}_out', tag='default', kind='avgpool')


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _tap(ctx: TapContext, y, site: Site | None):
    return ctx.tap(y, site) if site is not None else y


class QConv(nn.Module):
    """Conv2d with bias and a tapped output (Conv2dWithId analogue)."""

    def __init__(self, in_ch: int, features: int, kernel_size, strides=1, padding=0,
                 groups: int = 1, use_bias: bool = True, site: Site | None = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.strides, self.padding, self.groups = _pair(strides), _pair(padding), groups
        self.site = site
        self.weight = nn.Parameter(torch.empty(features, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator):
        # He-normal (fan_in), as the JAX package's he_normal init
        nn.init.kaiming_normal_(self.weight, mode='fan_in', nonlinearity='relu',
                                generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, ctx: TapContext):
        y = F.conv2d(x, self.weight, self.bias, self.strides, self.padding,
                     groups=self.groups)
        return _tap(ctx, y, self.site)


class QLinear(nn.Module):
    """Linear with a tapped output (LinearWithId analogue)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 site: Site | None = None):
        super().__init__()
        self.site = site
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator):
        nn.init.kaiming_normal_(self.weight, mode='fan_in', nonlinearity='relu',
                                generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, ctx: TapContext):
        return _tap(ctx, F.linear(x, self.weight, self.bias), self.site)


class QBatchNorm(nn.Module):
    """Inference-mode BatchNorm2d with a tapped output; only built for
    architectures whose BN is not folded into the preceding conv."""

    def __init__(self, features: int, eps: float = 1e-5, site: Site | None = None):
        super().__init__()
        self.eps, self.site = eps, site
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x, ctx: TapContext):
        shape = (1, -1, 1, 1)
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        y = (x.float() - self.running_mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
        return _tap(ctx, y.to(x.dtype), self.site)


class QMaxPool(nn.Module):
    """MaxPool2d with a tapped output (MaxPool2dWithId analogue)."""

    def __init__(self, window, strides, padding=0, ceil_mode: bool = False,
                 site: Site | None = None):
        super().__init__()
        self.window, self.strides, self.padding = _pair(window), _pair(strides), _pair(padding)
        self.ceil_mode, self.site = ceil_mode, site

    def forward(self, x, ctx: TapContext):
        y = F.max_pool2d(x, self.window, self.strides, self.padding,
                         ceil_mode=self.ceil_mode)
        return _tap(ctx, y, self.site)


class QAvgPool(nn.Module):
    """AvgPool2d (count_include_pad=True) with a tapped output.
    ``window=None`` pools over the input's height, as the JAX ResNet sizes its
    final pool from the feature map it receives."""

    def __init__(self, window=None, strides=None, padding=0, site: Site | None = None):
        super().__init__()
        self.window, self.strides, self.padding = window, strides, _pair(padding)
        self.site = site

    def forward(self, x, ctx: TapContext):
        w = _pair(self.window if self.window is not None else x.shape[2])
        s = _pair(self.strides) if self.strides is not None else w
        y = F.avg_pool2d(x.float(), w, s, self.padding, count_include_pad=True)
        return _tap(ctx, y.to(x.dtype), self.site)


class QGlobalAvgPool(nn.Module):
    """Adaptive 1x1 average pool, tapped like AvgPool2dWithId."""

    def __init__(self, site: Site | None = None):
        super().__init__()
        self.site = site

    def forward(self, x, ctx: TapContext):
        y = torch.mean(x.float(), dim=(2, 3), keepdim=True).to(x.dtype)
        return _tap(ctx, y, self.site)


def relu(x):
    """ReLU: the reference disables quantization of ReLU outputs
    (ReLUWithId, i_q_m.py:28-48), so no tap."""
    return torch.relu(x)


def init_parameters(model: nn.Module, seed: int):
    """Seeded He-normal init of every conv and linear, in module order, from
    one CPU ``torch.Generator`` (the same weights whatever the device)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (QConv, QLinear)):
                m.reset_parameters(gen)
    return model
