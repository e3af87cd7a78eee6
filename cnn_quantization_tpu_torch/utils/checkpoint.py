"""Checkpoints: torchvision state dicts, with BatchNorm folded into the
preceding conv/linear at load time, and the JAX package's flat ``.npz``
parameter trees.

The port's models use torchvision's names and layouts, so the first is the
JAX package's ``utils/torch_import.py`` (``fold_bn_state`` :48-86,
``load_torch_checkpoint`` :158-167) without the layout conversion; the
reference folds at run time instead (utils/absorb_bn.py:5-41).  The second is
``load_params_npz`` of the JAX package's ``utils/checkpoint.py`` :31-40 (the
tree its ``save_params_npz`` writes, keys joined by '/'); the CLI converts
such a tree with ``utils/flax_params.state_dict_from_flax``.
"""

from __future__ import annotations

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


def load_folded_state_dict(path: str, device) -> dict[str, torch.Tensor]:
    """A torchvision checkpoint, BN-folded, as float32 tensors on ``device``."""
    state, _ = fold_bn_state(load_torch_checkpoint(path))
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
