"""Sharded quantized evaluation over a (data, model) mesh of ranks.

Port of ``cnn_quantization_tpu/parallel/eval_parallel.py``: images split
over the ``data`` axis, per-channel weights over the ``model`` axis, and the
accuracy counts and loss sum all-reduced over the data group, so every rank
returns the same global result.  The reference scattered batches with
``DataParallel`` (inference_sim.py:196-200); the JAX package leaves the
collectives to GSPMD, the port makes them with ``torch.distributed``
(``parallel/mesh.py``).

With frozen qparams (``qparams``) or frozen serving scales (``act_scales``)
no quantization decision depends on the batch, so a sharded step computes
each image's logits as the single-device step does: the integer paths bit
for bit, the float paths up to the library's choice of algorithm for the
smaller shapes.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Mapping

import torch
import torch.distributed as dist

from ..calib.calibrator import stats_to_device
from ..engine.engine import QuantEngine
from ..utils.meters import accuracy_counts, cross_entropy_sum
from .mesh import Mesh, make_mesh, shard_batch, shard_params


def make_sharded_eval_step(engine: QuantEngine, mesh: Mesh, quantized: bool | str = True,
                           qparams=None, act_scales=None, packed: bool | tuple = False):
    """step(shard params, stats, local images, local labels) -> {'top1',
    'top5', 'loss'} summed over the global batch (float64 device scalars,
    the same on every rank) and this rank's ``logits``.  ``params`` is the
    rank's shard (``shard_params``), the images its slice of the batch
    (``shard_batch``, or ``distributed.make_global_batch``)."""
    fwd = engine.make_forward(quantized, qparams=qparams, act_scales=act_scales,
                              packed=packed, mesh=mesh)

    def step(params, stats, images, labels):
        logits, _ = fwd(params, stats, images)
        labels = torch.as_tensor(labels).to(logits.device).long()
        counts = accuracy_counts(logits, labels, ks=(1, 5))
        sums = torch.stack([counts[1].double(), counts[5].double(),
                            cross_entropy_sum(logits, labels).double()])
        if mesh.data_group is not None:
            dist.all_reduce(sums, group=mesh.data_group)
        return {'top1': sums[0], 'top5': sums[1], 'loss': sums[2], 'logits': logits}

    return step


def gather_batch(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's slice of a per-image tensor, in batch order."""
    if mesh.data_group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def evaluate_sharded(engine: QuantEngine, params, batches: Iterable, *,
                     mesh: Mesh | None = None, stats: Mapping[str, Any] | None = None,
                     quantized: bool | str = True, subset: int | None = None,
                     qparams=None, act_scales=None, packed: bool | tuple = False,
                     keep_logits: bool = False) -> dict[str, Any]:
    """Sharded eval loop over global batches (every rank iterates the same
    batches and takes its slice): {'top1', 'top5', 'loss',
    'images_per_sec'}, the global result on every rank.  ``params`` are the
    full (replicated) parameters; each rank keeps its shard.
    ``keep_logits`` adds the global batch's logits (gathered over the data
    group, on every rank).  ``images_per_sec`` counts the global images over
    the loop's host time, the device drained at its end."""
    mesh = mesh if mesh is not None else make_mesh()
    device = engine.device
    stats = stats_to_device(stats, device)
    shard = shard_params(params, mesh, engine.model)
    step = make_sharded_eval_step(engine, mesh, quantized, qparams=qparams,
                                  act_scales=act_scales, packed=packed)
    totals = torch.zeros(3, dtype=torch.float64, device=device)
    logits, seen = [], 0
    t0 = time.perf_counter()
    for images, labels in batches:
        if subset is not None and seen >= subset:
            break
        local_images, local_labels = shard_batch(mesh, images, labels)
        out = step(shard, stats, local_images, local_labels)
        totals += torch.stack([out['top1'], out['top5'], out['loss']])
        if keep_logits:
            logits.append(gather_batch(out['logits'], mesh))
        seen += images.shape[0]
    top1, top5, loss = totals.tolist()   # drains the device
    seconds = time.perf_counter() - t0
    seen_f = max(seen, 1)
    result = {'top1': 100.0 * top1 / seen_f, 'top5': 100.0 * top5 / seen_f,
              'loss': loss / seen_f, 'images_per_sec': seen / max(seconds, 1e-9)}
    if keep_logits:
        result['logits'] = torch.cat(logits) if logits else None
    return result
