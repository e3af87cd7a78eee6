"""Evaluation harness: eval step + host-side meter loop.

Port of ``cnn_quantization_tpu/engine/evaluate.py`` (reference
inference_sim.py:278-343, ``validate``).  Top-k counts and the loss stay on
the device and are read once, at the end (or at a verbose print, or at a
checkpoint of a resumable run), so the loop never waits on the card per
batch.  On the card, each batch is timed with CUDA events around its step; on
the CPU, with the host clock.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Iterable, Mapping

import torch

from ..calib.calibrator import stats_to_device
from ..utils import spans
from ..utils.meters import accuracy_counts, cross_entropy_sum
from .engine import QuantEngine

_END = object()


def _batch_sums(logits, labels):
    """(top-1 count, top-5 count, summed cross entropy) of one batch, on
    the device."""
    labels = torch.as_tensor(labels).to(logits.device).long()
    counts = accuracy_counts(logits, labels, ks=(1, 5))
    return counts[1], counts[5], cross_entropy_sum(logits, labels)


def make_eval_step(engine: QuantEngine, quantized: bool | str = True, qparams=None,
                   act_scales=None, packed: bool = False):
    fwd = engine.make_forward(quantized, qparams=qparams, act_scales=act_scales,
                              packed=packed)

    def step(params, stats, images, labels):
        logits, aux = fwd(params, stats, images)
        top1, top5, loss = _batch_sums(logits, labels)
        return {'top1': top1, 'top5': top5, 'loss': loss, 'aux': aux}

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
             packed: bool = False, resume_path: str | None = None,
             checkpoint_every: int = 50) -> dict[str, float]:
    """Run the eval loop; returns {'top1', 'top5', 'loss', 'images_per_sec'
    [, 'avg_entropy']}.  ``subset`` stops after N images.  ``images_per_sec``
    counts this run's images over the summed step times.
    ``quantized='serving_int8'`` runs the true-integer deployment path
    (with frozen ``act_scales`` if given).

    ``resume_path``: a JSON checkpoint of the meters, the JAX package's
    format (either package resumes the other's file), written every
    ``checkpoint_every`` batches and removed when the run completes.  A run
    restarted with the same path and a deterministic (unshuffled or
    same-seed) loader skips the batches counted in it, without moving them to
    the device, and continues the meters.  Only such a run reads the device's
    sums inside the loop, once a checkpoint.

    Spans (``utils/spans``): ``evaluate.stats``, the statistics' copy to the
    device, once a call; ``evaluate.fetch``, the wait on ``batches`` for each
    batch; ``evaluate.batch``, the loop body, which holds the forward's
    ``engine.forward`` and ``evaluate.meters`` (labels to the device, the
    counts, the loss, the entropy sums)."""
    device = engine.device
    with spans.span('evaluate.stats'):
        stats = stats_to_device(stats, device)
    fwd = engine.make_forward(quantized, qparams=qparams, act_scales=act_scales,
                              packed=packed)
    timer = _StepTimer(device)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    top1, top5, loss, ent_sum = (zero.clone() for _ in range(4))
    ent_weight, seen, skip = 0.0, 0, 0
    if resume_path and os.path.exists(resume_path):
        with open(resume_path) as f:
            ck = json.load(f)
        skip, seen, ent_weight = ck['batches'], ck['seen'], ck['ent_weight']
        # the file holds percent averages; a top-k sum is an integer count,
        # so rounding restores it exactly
        top1.fill_(round(ck['top1'] * seen / 100.0))
        top5.fill_(round(ck['top5'] * seen / 100.0))
        loss.fill_(ck['loss'] * seen)
        ent_sum.fill_(ck['ent_sum'])
        if verbose:
            print(f'=> resuming eval at batch {skip} ({seen} images)')
    seen_at_start = seen
    it = iter(batches)
    for i in itertools.count():
        with spans.span('evaluate.fetch'):
            item = next(it, _END)
        if item is _END:
            break
        images, labels = item
        if i < skip:
            continue
        if subset is not None and seen >= subset:
            break
        n = images.shape[0]
        with spans.span('evaluate.batch', batch=i, counts={'images': n}):
            timer.start()
            logits, aux = fwd(params, stats, images)
            with spans.span('evaluate.meters'):
                b1, b5, bl = _batch_sums(logits, labels)
                timer.stop()
                seen += n
                top1 += b1
                top5 += b5
                loss += bl
                for key in aux:
                    if key.endswith('/entropy'):
                        w = float(aux[key[:-len('/entropy')] + '/numel'])
                        ent_sum += aux[key] * w
                        ent_weight += w
            if verbose and i % print_freq == 0:
                print(f'Test: [{i}]\tLoss {float(loss) / seen:.4f}\t'
                      f'Prec@1 {100.0 * float(top1) / seen:.3f}\t'
                      f'Prec@5 {100.0 * float(top5) / seen:.3f}')
            if resume_path and (i + 1) % checkpoint_every == 0:
                _write_eval_checkpoint(resume_path, i + 1, seen, top1, top5, loss, ent_sum,
                                       ent_weight)
    seconds = timer.seconds()
    seen_f = max(seen, 1)
    result = {'top1': 100.0 * float(top1) / seen_f, 'top5': 100.0 * float(top5) / seen_f,
              'loss': float(loss) / seen_f,
              'images_per_sec': (seen - seen_at_start) / max(seconds, 1e-9)}
    if ent_weight > 0:
        result['avg_entropy'] = float(ent_sum) / ent_weight
    if resume_path and os.path.exists(resume_path):
        os.remove(resume_path)   # completed: clear the checkpoint
    return result


def _write_eval_checkpoint(path, batches, seen, top1, top5, loss, ent_sum, ent_weight):
    """The JAX package's ``_write_eval_checkpoint`` file (percent averages,
    the average loss, the entropy sums), written whole or not at all."""
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump({'batches': batches, 'seen': seen, 'top1': 100.0 * float(top1) / seen,
                   'top5': 100.0 * float(top5) / seen, 'loss': float(loss) / seen,
                   'ent_sum': float(ent_sum), 'ent_weight': ent_weight}, f)
    os.replace(tmp, path)
