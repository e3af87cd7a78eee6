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
a state dict).
"""

from __future__ import annotations

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
