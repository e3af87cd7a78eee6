"""Accuracy and averaging meters (port of ``cnn_quantization_tpu/utils/
meters.py``; reference utils/meters.py:21-126).  Top-k counts and the loss
are computed on the device; meters aggregate host scalars."""

from __future__ import annotations

import torch


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def accuracy_counts(logits, labels, ks=(1, 5)) -> dict[int, torch.Tensor]:
    """{k: correct count} as device scalars.  A stable descending sort
    breaks ties by class index, as ``jnp.argsort(-logits)`` does."""
    maxk = max(ks)
    top = torch.argsort(-logits, dim=-1, stable=True)[:, :maxk]
    correct = top == labels[:, None]
    return {k: torch.sum(correct[:, :k]) for k in ks}


def cross_entropy_sum(logits, labels):
    logp = logits - torch.amax(logits, dim=-1, keepdim=True)
    logp = logp - torch.log(torch.sum(torch.exp(logp), dim=-1, keepdim=True))
    return -torch.sum(torch.take_along_dim(logp, labels[:, None].long(), dim=-1))
