"""Dataset helpers: subsetting, class filtering, index views.

Port of ``cnn_quantization_tpu/data/dataset.py`` (reference utils/dataset.py:
LimitDataset, ByClassDataset, IdxDataset, RandomSamplerReplacment): plain
transformations of the (path, label) sample lists of ``data/imagenet.py``.
"""

from __future__ import annotations

import numpy as np


def limit_samples(samples, max_len: int):
    return samples[:min(max_len, len(samples))]


def by_class(samples, class_indices):
    keep = set(class_indices)
    return [(p, label) for p, label in samples if label in keep]


def index_view(samples, indices):
    return [samples[i] for i in indices]


def sample_with_replacement(samples, n: int, seed: int = 0):
    """``n`` samples drawn with replacement; the same seed draws the same
    indices as the JAX package (``np.random.RandomState``)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(samples), size=n)
    return [samples[i] for i in idx]
