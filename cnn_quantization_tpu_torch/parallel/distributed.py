"""Multi-process runtime: process-group initialisation and rank-sharded
evaluation input.

Port of ``cnn_quantization_tpu/parallel/distributed.py`` onto
``torch.distributed``.  The reference has no distributed backend (SURVEY.md
§5); the JAX package runs one process per host with ``jax.distributed``.
Here one process runs per device, as ``torchrun`` launches them (it sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``); each rank may feed only its own contiguous shard of the
validation samples (``host_shard``).  Without those variables every helper
is the single-process one.  Backend: NCCL for CUDA devices (one rank a
device: NCCL refuses two ranks on one GPU), gloo on the CPU, or wherever
it is asked for.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, world


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, *, backend: str | None = None,
                     device=None) -> bool:
    """Initialise the default process group from the arguments or torchrun's
    environment; False (and nothing done) without either.  ``backend``
    defaults to NCCL for a CUDA ``device`` (the card unless ``'cpu'``), else
    gloo."""
    if dist.is_initialized():
        return True
    if init_method is None and 'MASTER_ADDR' not in os.environ:
        return False
    if backend is None:
        dev = torch.device('cuda' if device is None else device)
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    dist.init_process_group(
        backend, init_method=init_method or 'env://',
        world_size=world_size if world_size is not None else int(os.environ.get('WORLD_SIZE', '1')),
        rank=rank if rank is not None else int(os.environ.get('RANK', '0')))
    return True


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for the card under torchrun,
    ``device`` itself otherwise."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and dev.index is None and 'LOCAL_RANK' in os.environ:
        return torch.device('cuda', int(os.environ['LOCAL_RANK']))
    return dev


def global_mesh(model_axis: int = 1) -> Mesh:
    """The mesh over every rank: the data axis spans the ranks, the model
    axis groups ``model_axis`` consecutive ranks."""
    _, n = world()
    if n % model_axis:
        raise ValueError(f'a model axis of {model_axis} does not divide {n} rank(s)')
    return make_mesh(data=n // model_axis, model=model_axis)


def host_shard(samples, *, process_index: int | None = None,
               process_count: int | None = None):
    """This rank's contiguous shard of the sample list, the JAX package's
    split (``-(-n // count)`` samples a rank, the last one short)."""
    rank, n = world()
    pi = rank if process_index is None else process_index
    pc = n if process_count is None else process_count
    per = -(-len(samples) // pc)
    return samples[pi * per:(pi + 1) * per]


def make_global_batch(mesh: Mesh, local_images, local_labels, device=None):
    """This rank's part of a globally sharded batch as tensors on its device
    (NHWC float32 images, int64 labels): the rank's slice along the data axis
    needs no assembly in torch, each rank feeds the step its own tensors."""
    dev = local_device(device)
    images = torch.as_tensor(np.asarray(local_images, np.float32)).to(dev)
    labels = torch.as_tensor(np.asarray(local_labels)).to(dev).long()
    return images, labels
