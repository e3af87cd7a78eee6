"""Everything a run feeds both sides, made from ``--seed``: the float
weights, the images and labels of the measured window, and the calibration
images.

The weights are drawn on the device by one ``torch.Generator`` in one call,
then scaled leaf by leaf: conv and linear kernels He-normal (std
sqrt(2 / fan_in)), biases and batch-norm shifts and means 0.1 x N(0, 1),
batch-norm gains 1 + 0.1 x N(0, 1), variances exp(0.2 x N(0, 1)).  Images are
uniform in [0, 1) per channel, normalized by the ImageNet mean and std (as the
program's synthetic loader draws them), NHWC float32; labels uniform over the
classes.  Host copies are pinned, as a loader's would be.
"""

from __future__ import annotations

import math

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# one generator a stream, so that each stream is the same whatever the others
# draw
WEIGHTS, IMAGES, CALIBRATION = 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 4 + stream)


def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor} for the parameter shapes ``shapes``."""
    gen = generator(seed, WEIGHTS, device)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[i:i + n].view(shape)
        i += n
        if name.endswith('.weight') and len(shape) in (2, 4):
            out[name] = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif name.endswith('running_var'):
            out[name] = torch.exp(0.2 * z)
        elif name.endswith('.weight'):            # a batch norm's gain
            out[name] = 1.0 + 0.1 * z
        else:                                      # biases, shifts, means
            out[name] = 0.1 * z
    return out


def make_images(n: int, size: int, seed: int, stream: int, device, classes: int = 1000):
    """``n`` NHWC float32 images and int32 labels on ``device``."""
    gen = generator(seed, stream, device)
    img = torch.rand((n, size, size, 3), generator=gen, device=device, dtype=torch.float32)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device, dtype=torch.int32)
    return (img - mean) / std, labels


def host_batches(images, labels, batch: int) -> list:
    """(images, labels) host batches of ``batch``, pinned where a card is."""
    pin = images.device.type == 'cuda'
    out = []
    for i in range(0, images.shape[0], batch):
        x, y = images[i:i + batch].cpu(), labels[i:i + batch].cpu()
        out.append((x.pin_memory(), y.pin_memory()) if pin else (x, y))
    return out
