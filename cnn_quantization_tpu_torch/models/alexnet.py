"""AlexNet (torchvision layout; NCHW in channels_last memory).

Port of ``cnn_quantization_tpu/models/alexnet.py``.  A fused-ReLU
architecture in the reference (force_positive activations) with no BN.
Module names are torchvision's (``features.0/3/6/8/10`` convs, the max pools
at ``features.2/5/12``, ``classifier.1/4/6``).  The 11x11 stride-4 stem has
in_ch == 3, so it stays a float conv on the serving path.  The three max-pool
sites are numbered in construction order, interleaved with the convs.

The feature map is flattened in (H, W, C) order, as the JAX model flattens
NHWC (see ``models/vgg.py``), and there is no adaptive pool: the first
classifier's width follows the input size (256 * 6 * 6 at 224x224).
"""

from __future__ import annotations

from torch import nn

from ..engine.context import TapContext
from .layers import QConv, QLinear, QMaxPool, ReLU, SiteNamer, Slot, run_all
from .vgg import flatten_hwc


def _conv_out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


class AlexNet(nn.Module):
    def __init__(self, sites: tuple, num_classes: int = 1000, input_size: int = 224):
        super().__init__()
        (c0, c1, c2, c3, c4), (m0, m1, m2), (l0, l1, l2) = sites
        self.features = nn.ModuleList([
            QConv(3, 64, 11, 4, 2, site=c0), ReLU(), QMaxPool(3, 2, site=m0),
            QConv(64, 192, 5, 1, 2, site=c1), ReLU(), QMaxPool(3, 2, site=m1),
            QConv(192, 384, 3, 1, 1, site=c2), ReLU(),
            QConv(384, 256, 3, 1, 1, site=c3), ReLU(),
            QConv(256, 256, 3, 1, 1, site=c4), ReLU(), QMaxPool(3, 2, site=m2)])
        size = _conv_out(_conv_out(input_size, 11, 4, 2), 3, 2, 0)   # stem, pool
        size = _conv_out(_conv_out(size, 3, 2, 0), 3, 2, 0)         # two more pools
        self.classifier = nn.ModuleList([
            Slot(), QLinear(256 * size * size, 4096, site=l0), ReLU(),
            Slot(), QLinear(4096, 4096, site=l1), ReLU(),
            QLinear(4096, num_classes, site=l2)])

    def forward(self, x, ctx: TapContext):
        """``x``: NCHW float32 (channels_last in memory) -> float32 logits."""
        x = run_all(self.features, x, ctx)
        return run_all(self.classifier, flatten_hwc(x), ctx)


def build_alexnet(num_classes: int = 1000, input_size: int = 224) -> AlexNet:
    n = SiteNamer()
    convs = tuple(n.conv() for _ in range(5))
    pools = (n.maxpool(), n.maxpool(), n.maxpool())
    linears = (n.linear(), n.linear(), n.linear(classifier=True))
    return AlexNet((convs, pools, linears), num_classes=num_classes, input_size=input_size)
