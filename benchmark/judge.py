"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, as a few numbers, each held to its cell's limit
(``limits/<cell>.json``).

* ``weights``: the prepared parameters (the simulation's 4-bit bias-corrected
  weights; serving's int8 codes, their scales and the float stem), by the
  worst leaf: max |program - reference| / max |reference| of the leaf.
* ``qparams``: the simulation's frozen (delta, offset, qmax) by the worst site:
  max of |delta and offset gaps| / max |delta| and |qmax gap| / max qmax.
* ``scales``: serving's frozen input scales by the worst site, relative.
* ``logits``: every forward of the window against the reference's logits of
  the same images: max |gap| / max |reference| of each, the worst.
* ``loss``: the sweep's mean cross entropy (``evaluate``'s, over every batch of
  the window) against the reference's over the same batches, relative.
* ``topk``: the sweep's top-1 and top-5 counts (``evaluate``'s) against the
  counts of the logits the window's forwards returned, by the plain rank of
  each label: exact, limit 0.  Those logits are held to the reference's by
  ``logits``, so no image is left out as too close to call.

A leaf, site or key on one side only reads infinity.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INF = float('inf')
# what a result line prints for a number that is not finite (JSON has no inf)
NOT_FINITE = 1e300


def _rel(p, r) -> float:
    p = torch.as_tensor(p).double().cpu()
    r = torch.as_tensor(r).double().cpu()
    if p.shape != r.shape:
        return INF
    scale = r.abs().max().item() if r.numel() else 0.0
    gap = (p - r).abs().max().item() if r.numel() else 0.0
    if not math.isfinite(gap):
        return INF
    return gap / scale if scale > 0 else gap


def tree_gap(prog: dict, ref: dict) -> float:
    if set(prog) != set(ref):
        return INF
    return max((_rel(prog[k], ref[k]) for k in ref), default=0.0)


def _d(v):
    return torch.as_tensor(v).double().cpu()


def qparams_gap(prog: dict, ref: dict) -> float:
    if set(prog) != set(ref):
        return INF
    worst = 0.0
    for k, (delta, offset, qmax, pc) in ref.items():
        p = prog[k]
        if bool(p.per_channel) != bool(pc) or _d(p.delta).shape != _d(delta).shape:
            return INF
        scale = _d(delta).abs().max().item()
        for a, b in ((p.delta, delta), (p.offset, offset)):
            a, b = torch.broadcast_tensors(_d(a), _d(b))
            worst = max(worst, (a - b).abs().max().item() / scale)
        worst = max(worst, _rel(*torch.broadcast_tensors(_d(p.qmax), _d(qmax))))
    return worst if math.isfinite(worst) else INF


def scales_gap(prog: dict, ref: dict) -> float:
    if set(prog) != set(ref):
        return INF
    return max((_rel(np.asarray(prog[k], np.float64), np.asarray(ref[k], np.float64))
                for k in ref), default=0.0)


def logits_gap(logits: list, order: list, ref: dict) -> float:
    return max((_rel(l, ref[k]) for l, k in zip(logits, order)), default=INF)


def _ce_sum(logits, labels) -> float:
    logp = torch.log_softmax(logits.double(), dim=-1)
    return -logp.gather(1, labels.long().view(-1, 1)).sum().item()


def _counts(logits, labels, ks=(1, 5)) -> dict:
    """{k: images whose label ranks among the top k}: its rank is the number
    of classes with a larger logit, or an equal one and a smaller index (ties
    broken by class index, as ``evaluate`` states its counts do)."""
    own = logits.gather(1, labels.long().view(-1, 1))
    idx = torch.arange(logits.shape[1], device=logits.device)
    rank = (logits > own).sum(1) + ((logits == own) & (idx < labels.long().view(-1, 1))).sum(1)
    return {k: int((rank < k).sum()) for k in ks}


def sweep_numbers(window: dict, pool_labels: list, ref_logits: dict):
    """``loss`` and ``topk`` of a sweep window."""
    order, result = window['order'], window['result']
    counts = {k: order.count(k) for k in set(order)}
    seen = window['images']
    ce = sum(n * _ce_sum(ref_logits[k], pool_labels[k]) for k, n in counts.items())
    ref_loss = ce / max(seen, 1)
    loss = abs(result['loss'] - ref_loss) / abs(ref_loss)
    hits = {1: 0, 5: 0}
    for logits, k in zip(window['logits'], order):
        for k_top, n in _counts(logits, pool_labels[k].to(logits.device)).items():
            hits[k_top] += n
    topk = max(abs(round(result[f'top{k_top}'] * seen / 100.0) - n) for k_top, n in hits.items())
    return {'loss': loss, 'topk': topk}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {'value', 'limit'}}): every number within its limit,
    and a limit for every number."""
    checks = {k: {'value': v if math.isfinite(v) else NOT_FINITE, 'limit': limits.get(k)}
              for k, v in numbers.items()}
    ok = all(c['limit'] is not None and c['value'] <= c['limit'] for c in checks.values())
    return ok, checks
