"""Checkpoints: torchvision state dicts, with BatchNorm folded into the
preceding conv/linear at load time where the architecture folds, and the JAX
package's flat ``.npz`` parameter trees.

The port's models use torchvision's names and layouts, so the first is the
JAX package's ``utils/torch_import.py`` (``fold_bn_state`` :48-86,
``load_torch_checkpoint`` :158-167, ``import_arch`` :180-191) without the
conv layout conversion; the reference folds at run time instead
(utils/absorb_bn.py:5-41).  Per architecture, as ``import_arch``:
Inception-v3 folds with its BN eps of 1e-3 and drops the aux tower
(``AuxLogits.*``, which the port never builds; GoogLeNet's ``aux1.*``/
``aux2.*`` likewise), and VGG and AlexNet permute their first classifier from
torchvision's (C, H, W) flatten order to the (H, W, C) order the port
flattens in (``models/vgg.py``).  The second is ``load_params_npz`` of the
JAX package's ``utils/checkpoint.py`` :31-40 (the tree its
``save_params_npz`` writes, keys joined by '/'); the CLI converts such a tree
with ``utils/flax_params.state_dict_from_flax``.  ``save_params_npz`` (:25-28)
writes such a tree (``utils/flax_params.flax_from_state_dict`` makes one from
a state dict).  ``save_params_sharded``/``load_params_sharded`` are the
counterpart of ``save_params_orbax``/``load_params_orbax`` (:42-51, for
large sharded checkpoints), on ``torch.distributed.checkpoint`` (DCP).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch

BN_EPS = 1e-5


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A .pth/.pt state dict as {key: np.ndarray}."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    if 'state_dict' in obj and isinstance(obj['state_dict'], dict):
        obj = obj['state_dict']
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _module_prefixes(state: Mapping[str, np.ndarray]):
    seen = []
    for k in state:
        prefix = k.rsplit('.', 1)[0]
        if prefix not in seen:
            seen.append(prefix)
    return seen


def fold_bn_state(state: Mapping[str, np.ndarray], eps: float = BN_EPS):
    """Fold each BN into the directly preceding conv/linear
    (absorb_bn.py:34-41); depthwise convs stay unfolded, as the reference's
    groups == 1 restriction.  Returns (new_state, folded_bn_prefixes)."""
    state = dict(state)
    prefixes = _module_prefixes(state)
    folded = []
    for prev, cur in zip(prefixes, prefixes[1:]):
        if f'{cur}.running_mean' not in state:
            continue
        w = state.get(f'{prev}.weight')
        if w is None or w.ndim not in (2, 4):
            continue
        if w.ndim == 4 and w.shape[1] == 1 and w.shape[0] > 1:
            continue
        rm = state[f'{cur}.running_mean'].astype(np.float64)
        rv = state[f'{cur}.running_var'].astype(np.float64)
        invstd = 1.0 / np.sqrt(rv + eps)
        w = w.astype(np.float64)
        b = state.get(f'{prev}.bias')
        b = np.zeros(w.shape[0]) if b is None else b.astype(np.float64)
        shape = (-1,) + (1,) * (w.ndim - 1)
        w = w * invstd.reshape(shape)
        b = (b - rm) * invstd
        gamma = state.get(f'{cur}.weight')
        beta = state.get(f'{cur}.bias')
        if gamma is not None:
            w = w * gamma.astype(np.float64).reshape(shape)
            b = b * gamma.astype(np.float64) + beta.astype(np.float64)
        state[f'{prev}.weight'] = w.astype(np.float32)
        state[f'{prev}.bias'] = b.astype(np.float32)
        for suffix in ('running_mean', 'running_var', 'weight', 'bias',
                       'num_batches_tracked'):
            state.pop(f'{cur}.{suffix}', None)
        folded.append(cur)
    return state, folded


# aux towers of torchvision checkpoints that the port never builds
_AUX_PREFIXES = {'inception_v3': ('AuxLogits.',), 'googlenet': ('aux1.', 'aux2.')}
# BN eps of the architectures built from BasicConv2d
_BN_EPS = {'inception_v3': 1e-3, 'googlenet': 1e-3}


def _first_classifier(arch: str) -> str | None:
    """The linear that consumes the flattened feature map, if any."""
    if arch.startswith('vgg'):
        return 'classifier.0'
    return 'classifier.1' if arch == 'alexnet' else None


def to_hwc_flatten_order(w: np.ndarray, channels: int) -> np.ndarray:
    """A linear kernel [out, C*H*W] over torchvision's (C, H, W) flatten ->
    the same kernel over the (H, W, C) order (a square H x W map)."""
    hw = w.shape[1] // channels
    side = int(round(hw ** 0.5))
    if channels * side * side != w.shape[1]:
        raise ValueError(f'a [{w.shape[0]}, {w.shape[1]}] classifier does not flatten a square '
                         f'map of {channels} channels')
    return (w.reshape(w.shape[0], channels, side, side).transpose(0, 2, 3, 1)
            .reshape(w.shape[0], -1))


def import_state(state: Mapping[str, np.ndarray], arch: str, fold_bn: bool):
    """A torchvision state dict in the port's layout for ``arch``: the aux
    towers and BN step counters dropped, BN folded when ``fold_bn`` (with the
    arch's eps), the flattened classifier in (H, W, C) order."""
    aux = _AUX_PREFIXES.get(arch, ())
    state = {k: v for k, v in state.items()
             if not k.startswith(aux) and not k.endswith('.num_batches_tracked')}
    if fold_bn:
        state, _ = fold_bn_state(state, eps=_BN_EPS.get(arch, BN_EPS))
    first = _first_classifier(arch)
    if first is not None:
        channels = [v for v in state.values() if v.ndim == 4][-1].shape[0]
        state[f'{first}.weight'] = to_hwc_flatten_order(state[f'{first}.weight'], channels)
    return state


def load_torchvision_state_dict(path: str, arch: str, fold_bn: bool,
                                device) -> dict[str, torch.Tensor]:
    """A torchvision checkpoint for ``arch`` (``import_state``) as float32
    tensors on ``device``."""
    state = import_state(load_torch_checkpoint(path), arch, fold_bn)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in state.items()}


def load_params_npz(path: str) -> dict[str, Any]:
    """The nested tree the JAX package's ``save_params_npz`` wrote."""
    out: dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split('/')
            for seg in parts[:-1]:
                node = node.setdefault(seg, {})
            node[parts[-1]] = data[key]
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = ''):
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def save_params_npz(path: str, params: Mapping[str, Any]):
    """A nested parameter tree as the JAX package's flat ``.npz`` (keys joined
    by '/'), which ``load_params_npz`` of either package reads."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **dict(_flatten(params)))


def _first_rows(params: Mapping[str, torch.Tensor], mesh, model, rows_per_rank):
    """{name: first row of this rank's slice} of the entries a model axis
    splits along axis 0 (``parallel.param_sharding``'s rule); ``{}`` without
    a mesh or on a mesh without a model axis."""
    if mesh is None or mesh.model == 1:
        return {}
    if model is None:
        raise ValueError('a mesh with a model axis needs the model: its modules say which '
                         'entries the axis splits')
    from ..parallel.mesh import param_sharding
    spec = param_sharding(mesh, params, model)
    return {k: mesh.model_index * rows_per_rank(params[k]) for k, s in spec.items()
            if s == 'model'}


def _offsets(first_row: int, ndim: int) -> torch.Size:
    return torch.Size(([first_row] + [0] * ndim)[:ndim])


def _slice_planners():
    """DCP's default planners with each entry placed by its first row: a
    rank's slice of a model-axis entry is written and read as its chunk of
    the full tensor.  (The default save planner treats every plain tensor as
    replicated and writes it from one rank, which would keep one slice.)"""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import (ChunkStorageMetadata, MetadataIndex,
                                                       TensorProperties)
    from torch.distributed.checkpoint.planner import (LoadPlan, SavePlan, TensorWriteData,
                                                      WriteItem, WriteItemType)
    from torch.distributed.checkpoint.planner_helpers import create_read_items_for_chunk_list

    class SlicePlanner(dcp.DefaultSavePlanner):
        def __init__(self, first_rows, slices):
            super().__init__(flatten_state_dict=False)
            self.first_rows, self.slices = first_rows, slices

        def create_local_plan(self):
            self.plan = SavePlan([self._item(k, t) for k, t in self.state_dict.items()])
            return self.plan

        def _item(self, name, t):
            offsets = _offsets(self.first_rows.get(name, 0), t.ndim)
            size = t.shape
            if name in self.first_rows:
                size = torch.Size((t.shape[0] * self.slices,) + t.shape[1:])
            channels_last = t.ndim == 4 and not t.is_contiguous() \
                and t.is_contiguous(memory_format=torch.channels_last)
            props = dataclasses.replace(
                TensorProperties.create_from_tensor(t),
                memory_format=torch.channels_last if channels_last else torch.contiguous_format)
            return WriteItem(index=MetadataIndex(name, offsets),
                             type=WriteItemType.SHARD if name in self.first_rows
                             else WriteItemType.TENSOR,
                             tensor_data=TensorWriteData(
                                 chunk=ChunkStorageMetadata(offsets, t.shape),
                                 properties=props, size=size))

        def lookup_object(self, index):
            return self.state_dict[index.fqn]

    class SliceLoadPlanner(dcp.DefaultLoadPlanner):
        def __init__(self, first_rows):
            super().__init__(flatten_state_dict=False)
            self.first_rows = first_rows

        def create_local_plan(self):
            items = []
            for name, t in self.state_dict.items():
                chunk = ChunkStorageMetadata(_offsets(self.first_rows.get(name, 0), t.ndim),
                                             t.shape)
                items += create_read_items_for_chunk_list(
                    name, self.metadata.state_dict_metadata[name], [chunk])
            return LoadPlan(items)

        def lookup_tensor(self, index):
            return self.state_dict[index.fqn]

    return dcp, SlicePlanner, SliceLoadPlanner


def save_params_sharded(path: str, params: Mapping[str, torch.Tensor], mesh=None, model=None):
    """Write a flat parameter dict as a DCP checkpoint directory ``path``.
    Under a mesh with a model axis, ``params`` are this rank's
    (``parallel.shard_params``): each slice is written as its rows of the
    full tensor, so the checkpoint holds every full tensor once, whatever the
    mesh, and an entry replicated over ranks is written by one of them.
    Under a process group every rank calls it; with one rank, or none, it
    writes alone.  Each entry keeps its dtype, values and (4-D) memory
    format."""
    from ..parallel.mesh import Mesh, world
    dcp, planner, _ = _slice_planners()
    bad = [k for k, v in params.items() if not isinstance(v, torch.Tensor)]
    if bad:
        raise TypeError(f'only tensors can be saved, not the values of {bad[:5]}')
    mesh = mesh or Mesh()
    first_rows = _first_rows(params, mesh, model, lambda t: t.shape[0])
    dcp.save(dict(params), storage_writer=dcp.FileSystemWriter(path),
             planner=planner(first_rows, mesh.model), no_dist=world()[1] == 1)


def load_params_sharded(path: str, mesh=None, model=None, device=None) -> dict[str, torch.Tensor]:
    """The parameters of a ``save_params_sharded`` checkpoint as fresh
    tensors on ``device`` (the card unless ``'cpu'``), each in its saved
    dtype and memory format: the full tensors without a mesh (or on one
    without a model axis), this rank's slices on a mesh with one (equal to
    ``parallel.shard_params`` of the full tensors).  Each rank reads its own
    part; no collective runs."""
    from ..parallel.mesh import Mesh
    from .device import resolve_device
    dcp, _, planner = _slice_planners()
    reader = dcp.FileSystemReader(path)
    md = reader.read_metadata().state_dict_metadata
    mesh = mesh or Mesh()
    full = {k: torch.empty(m.size, dtype=m.properties.dtype, device='meta') for k, m in md.items()}
    first_rows = _first_rows(full, mesh, model, lambda t: t.shape[0] // mesh.model)
    dev = resolve_device(device)
    out = {}
    for k, m in md.items():
        shape = m.size if k not in first_rows else (m.size[0] // mesh.model,) + m.size[1:]
        out[k] = torch.empty(shape, dtype=m.properties.dtype, device=dev,
                             memory_format=getattr(m.properties, 'memory_format',
                                                   torch.contiguous_format))
    dcp.load(out, storage_reader=reader, planner=planner(first_rows), no_dist=True)
    return out
