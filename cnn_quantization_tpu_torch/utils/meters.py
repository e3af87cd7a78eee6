"""Accuracy and averaging meters (port of ``cnn_quantization_tpu/utils/
meters.py``; reference utils/meters.py:21-126).  Top-k counts and the loss
are computed on the device; ``AverageMeter`` and ``AccuracyMeter`` aggregate
host scalars, ``OnlineMeter`` keeps its running state on the device of its
samples."""

from __future__ import annotations

import torch

from .device import as_f32


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


class OnlineMeter:
    """Streaming elementwise mean/variance by Welford's algorithm, in float32
    (reference utils/meters.py:45-78), in the JAX class's update order.  The
    shape comes from the first ``update``, the state lives on its device;
    ``var`` uses the unbiased (n-1) denominator and is zero until two samples
    have been seen.  Each divisor is a device tensor: CUDA divides by a host
    number through its reciprocal, which is not float32 division."""

    def __init__(self):
        self.mean = torch.full((1,), -1.0)
        self.M2 = torch.zeros(1)
        self.count = 0
        self.val = None

    def reset(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        self.mean = torch.zeros_like(x)
        self.M2 = torch.zeros_like(x)
        self.count = 0

    def update(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        self.val = x
        if self.count == 0:
            if x.shape != self.mean.shape:
                self.reset(x)
            self.mean, self.M2 = self.mean.to(x.device), self.M2.to(x.device)
        self.count += 1
        delta = x - self.mean
        self.mean = self.mean + delta / as_f32(self.count, x.device)
        self.M2 = self.M2 + delta * (x - self.mean)

    @property
    def var(self):
        if self.count < 2:
            return torch.zeros_like(self.M2)
        return self.M2 / as_f32(self.count - 1, self.M2.device)

    @property
    def std(self):
        return torch.sqrt(self.var)


class AccuracyMeter:
    """Running top-k accuracy in percent (reference utils/meters.py:98-126);
    ``val``, ``avg`` and ``avg_error`` are dicts keyed by k."""

    def __init__(self, topk=(1,)):
        self.topk = tuple(topk)
        self.reset()

    def reset(self):
        self._meters = {k: AverageMeter() for k in self.topk}

    def update(self, logits, labels):
        logits = torch.as_tensor(logits)
        labels = torch.as_tensor(labels, device=logits.device)
        n = labels.numel()
        counts = accuracy_counts(logits, labels, ks=self.topk)
        for k in self.topk:
            self._meters[k].update(100.0 * float(counts[k]) / n, n)

    @property
    def val(self):
        return {k: m.val for k, m in self._meters.items()}

    @property
    def avg(self):
        return {k: m.avg for k, m in self._meters.items()}

    @property
    def avg_error(self):
        return {k: 100.0 - m.avg for k, m in self._meters.items()}


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
