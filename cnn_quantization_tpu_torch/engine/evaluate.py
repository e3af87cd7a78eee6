"""Evaluation harness: eval step + host-side meter loop.

Port of ``cnn_quantization_tpu/engine/evaluate.py`` (reference
inference_sim.py:278-343, ``validate``).  Top-k counts and the loss stay on
the device and are read once, at the end (or at a verbose print), so the loop
never waits on the card per batch.  On the card, each batch is timed with
CUDA events around its step; on the CPU, with the host clock.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Mapping

import torch

from ..calib.calibrator import stats_to_device
from ..utils.meters import accuracy_counts, cross_entropy_sum
from .engine import QuantEngine


def make_eval_step(engine: QuantEngine, quantized: bool | str = True, qparams=None,
                   act_scales=None, packed: bool = False):
    fwd = engine.make_forward(quantized, qparams=qparams, act_scales=act_scales,
                              packed=packed)

    def step(params, stats, images, labels):
        logits, aux = fwd(params, stats, images)
        labels = torch.as_tensor(labels).to(logits.device).long()
        counts = accuracy_counts(logits, labels, ks=(1, 5))
        loss = cross_entropy_sum(logits, labels)
        return {'top1': counts[1], 'top5': counts[5], 'loss': loss, 'aux': aux}

    return step


class _StepTimer:
    """Per-step time: CUDA events on the card, host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.pairs: list = []
        self.host = 0.0

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs.append([ev, None])
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs[-1][1] = ev
        else:
            self.host += time.perf_counter() - self._t0

    def seconds(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3
        return self.host


def evaluate(engine: QuantEngine, params, batches: Iterable, *,
             stats: Mapping[str, Any] | None = None, quantized: bool | str = True,
             subset: int | None = None, print_freq: int = 10,
             verbose: bool = False, qparams=None, act_scales=None,
             packed: bool = False) -> dict[str, float]:
    """Run the eval loop; returns {'top1', 'top5', 'loss', 'images_per_sec'
    [, 'avg_entropy']}.  ``subset`` stops after N images.  ``images_per_sec``
    counts the images over the summed step times.
    ``quantized='serving_int8'`` runs the true-integer deployment path
    (with frozen ``act_scales`` if given)."""
    device = engine.device
    stats = stats_to_device(stats, device)
    step = make_eval_step(engine, quantized, qparams=qparams, act_scales=act_scales,
                          packed=packed)
    timer = _StepTimer(device)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    top1, top5, loss = zero.clone(), zero.clone(), zero.clone()
    ent_sum, ent_weight = zero.clone(), 0.0
    seen = 0
    for i, (images, labels) in enumerate(batches):
        if subset is not None and seen >= subset:
            break
        timer.start()
        out = step(params, stats, images, labels)
        timer.stop()
        n = images.shape[0]
        seen += n
        top1 += out['top1']
        top5 += out['top5']
        loss += out['loss']
        aux = out['aux']
        for key in aux:
            if key.endswith('/entropy'):
                w = float(aux[key[:-len('/entropy')] + '/numel'])
                ent_sum += aux[key] * w
                ent_weight += w
        if verbose and i % print_freq == 0:
            print(f'Test: [{i}]\tLoss {float(loss) / seen:.4f}\t'
                  f'Prec@1 {100.0 * float(top1) / seen:.3f}\t'
                  f'Prec@5 {100.0 * float(top5) / seen:.3f}')
    seconds = timer.seconds()
    seen_f = max(seen, 1)
    result = {'top1': 100.0 * float(top1) / seen_f, 'top5': 100.0 * float(top5) / seen_f,
              'loss': float(loss) / seen_f, 'images_per_sec': seen / max(seconds, 1e-9)}
    if ent_weight > 0:
        result['avg_entropy'] = float(ent_sum) / ent_weight
    return result
