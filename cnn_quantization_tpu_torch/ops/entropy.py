"""Entropy / rate measurement of quantized codes (port of
``cnn_quantization_tpu/ops/entropy.py``; reference utils/entropy.py:6-36).
A fixed-size bincount over the shifted code space keeps the shapes static."""

from __future__ import annotations

import torch

_MAX_CODES = 1 << 17


def _counts(codes, max_codes: int) -> torch.Tensor:
    c = codes.reshape(-1)
    c = c - torch.min(c)
    c = torch.clamp(c, 0, max_codes - 1).to(torch.int64)
    return torch.bincount(c, minlength=max_codes)


def shannon_entropy(codes, max_codes: int = _MAX_CODES):
    """Entropy (bits/value) of an integer-valued tensor."""
    counts = _counts(codes, max_codes).float()
    probs = counts / torch.sum(counts)
    probs = torch.where(probs == 0, 1.0, probs)
    return -torch.sum(probs * torch.log2(probs))


def most_frequent_value_compression(codes, base_bit: int = 8, compressed_bit: int = 1,
                                    max_codes: int = _MAX_CODES):
    """Rate if the most frequent value is coded with ``compressed_bit`` bits."""
    n = codes.numel()
    mfv = torch.max(_counts(codes, max_codes))
    return (mfv * compressed_bit + (n - mfv) * base_bit) / n
