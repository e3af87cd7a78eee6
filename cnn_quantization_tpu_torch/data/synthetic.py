"""Synthetic ImageNet-like data for benchmarks and tests (no dataset needed).

A copy of ``cnn_quantization_tpu/data/synthetic.py``: the same seed gives the
same NHWC batches in both packages.

Deterministic: images are generated from a fixed PRNG key; labels are derived
so a "cheating" classifier could fit them, which is irrelevant for throughput
benchmarking and shape/parity tests.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def synthetic_batches(batch_size: int, num_batches: int, *, size: int = 224,
                      num_classes: int = 1000, seed: int = 12345):
    """Yield (images NHWC float32 normalized, labels int32) batches."""
    rng = np.random.RandomState(seed)
    for _ in range(num_batches):
        img = rng.rand(batch_size, size, size, 3).astype(np.float32)
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        labels = rng.randint(0, num_classes, size=batch_size).astype(np.int32)
        yield img, labels
