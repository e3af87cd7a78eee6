"""Small shared utilities.

Port of ``cnn_quantization_tpu/utils/misc.py`` (reference utils/misc.py:
cos_sim :23-34, onehot :37-52, set_global_seeds :55-64, sorted_nicely
:79-88, torch_dtypes :5-20).  The reference's ``Singleton`` metaclass
(:67-73) has no counterpart: state lives in objects the caller holds.
"""

from __future__ import annotations

import random
import re

import numpy as np
import torch

# dtype-name table (reference torch_dtypes, utils/misc.py:5-20)
TORCH_DTYPES = {
    'float': torch.float32, 'float32': torch.float32, 'float64': torch.float64,
    'double': torch.float64, 'float16': torch.float16, 'half': torch.float16,
    'bfloat16': torch.bfloat16,
    'uint8': torch.uint8, 'int8': torch.int8, 'int16': torch.int16, 'short': torch.int16,
    'int32': torch.int32, 'int': torch.int32, 'int64': torch.int64, 'long': torch.int64,
}


def cos_sim(x: torch.Tensor, y: torch.Tensor, dims=(-1,)) -> torch.Tensor:
    """Cosine similarity reduced over ``dims``; the other axes are kept (the
    per-sample similarity of [N, D] activations)."""
    dims = tuple(dims)
    dot = torch.sum(x * y, dim=dims)
    nx = torch.sqrt(torch.sum(x * x, dim=dims))
    ny = torch.sqrt(torch.sum(y * y, dim=dims))
    return dot / (nx * ny)


def onehot(indexes: torch.Tensor, N: int | None = None,
           ignore_index: int | None = None) -> torch.Tensor:
    """One-hot encode an integer tensor as uint8 (reference utils/misc.py:37-52)."""
    if N is None:
        N = int(indexes.max()) + 1
    out = (indexes[..., None] == torch.arange(N, device=indexes.device)).to(torch.uint8)
    if ignore_index is not None and ignore_index >= 0:
        out = torch.where(indexes[..., None] == ignore_index, torch.zeros_like(out), out)
    return out


def sorted_nicely(items):
    """Human/alphanumeric sort (reference utils/misc.py:79-88): conv2 <
    conv10, used for ordering site ids."""
    def convert(text):
        return int(text) if text.isdigit() else text

    def key(s):
        return [convert(c) for c in re.split(r'([0-9]+)', s)]

    return sorted(items, key=key)


def set_global_seeds(i: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators (reference
    utils/misc.py:55-64) and return a ``torch.Generator`` seeded with ``i``,
    for code that takes its randomness explicitly."""
    random.seed(i)
    np.random.seed(i)
    torch.manual_seed(i)
    return torch.Generator().manual_seed(i)
