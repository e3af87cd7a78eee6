"""Weight bridge: the JAX package's parameter tree -> the port's state dict.

The inverse of the naming in ``cnn_quantization_tpu/utils/torch_import.py``
(``_flax_path``, :89-102): a numeric path segment merged into its parent
(``layer1_0``, ``downsample_0``, VGG's ``features_0``, GoogLeNet's
``branch2_0``) is split back out (``layer1.0``, ``downsample.0``,
``features.0``, ``branch2.0``).  Inception-v3's own names carry a trailing
``_<digits>`` in torchvision itself (``branch5x5_1``, ``branch3x3dbl_2``,
``branch7x7x3_4``): nothing was merged into them, so for that architecture no
segment is split (``state_dict_from_flax(..., arch='inception_v3')``).  HWIO
conv kernels become OIHW, ``[in, out]`` linear kernels ``[out, in]``; BN
leaves (scale/bias/mean/var) take torchvision's names.  A
*prepared serving tree* converts the same way: int8 ``kernel`` leaves keep
their dtype (4-D codes land in channels_last memory, as
``prepare_serving_params`` stores them; the s2d stem ``[4, 4, 12, O]`` becomes
``[O, 12, 4, 4]``) and ``w_scale`` leaves become ``<module>.w_scale``.
``act_scales_from_jax`` carries the frozen serving scales across.  With these
both packages compute on identical weights, codes and scales.
``flax_from_state_dict`` is the inverse: a port state dict as the JAX
package's tree, which ``utils/checkpoint.save_params_npz`` writes in the
JAX package's ``.npz`` layout (the k-means CLI's output, which both CLIs'
``--weights`` read).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LEAF_NAMES = {'bias': 'bias', 'scale': 'weight', 'mean': 'running_mean',
               'var': 'running_var', 'w_scale': 'w_scale'}


# architectures whose JAX names merged no numeric torch segment: every
# ``<name>_<digits>`` there is torchvision's own module name
_UNSPLIT_ARCHS = ('inception_v3',)


def _torch_segment(seg: str) -> str:
    """'layer1_0' -> 'layer1.0'; 'conv1' -> 'conv1'."""
    m = re.fullmatch(r'(.+?)((?:_\d+)+)', seg)
    if m is None:
        return seg
    return '.'.join([m.group(1)] + m.group(2).split('_')[1:])


def _walk(tree: Mapping[str, Any], path: tuple[str, ...]):
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield path, leaves
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))


def state_dict_from_flax(params: Mapping[str, Any],
                         arch: str | None = None) -> dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays) -> {torch name: tensor}: float32,
    apart from int8 kernel codes of a prepared serving tree.  ``arch`` names
    the architecture the tree belongs to (it decides which names split)."""
    split = _torch_segment if arch not in _UNSPLIT_ARCHS else (lambda seg: seg)
    out: dict[str, torch.Tensor] = {}
    for path, leaves in _walk(params, ()):
        prefix = '.'.join(split(seg) for seg in path)
        for name, value in leaves.items():
            v = np.asarray(value)
            codes = name == 'kernel' and v.dtype == np.int8
            if not codes:
                v = v.astype(np.float32)
            if name == 'kernel':
                if v.ndim == 4:
                    v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif v.ndim == 2:
                    v = v.T  # [in, out] -> [out, in]
                else:
                    raise ValueError(f'{prefix}: unexpected {v.ndim}-D kernel')
                key = 'weight'
            elif name in _LEAF_NAMES:
                key = _LEAF_NAMES[name]
            else:
                raise ValueError(f'{prefix}: no torch counterpart for leaf {name!r}')
            t = torch.tensor(v)  # a contiguous copy
            if codes and t.ndim == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            out[f'{prefix}.{key}'] = t
    return out


def act_scales_from_jax(scales: Mapping[str, Any]) -> dict[str, Any]:
    """The JAX package's frozen serving ``act_scales`` (site id -> float, or
    an ``[in_ch]`` float32 vector for grouped convs) as the port takes them.
    Site ids and the channel order are the same in both packages."""
    return {k: (float(v) if np.ndim(v) == 0 else np.asarray(v, np.float32).copy())
            for k, v in scales.items()}


_FLAX_LEAF_NAMES = {v: k for k, v in _LEAF_NAMES.items()}


def _flax_segments(segments, arch: str | None):
    """Torch path segments -> the JAX tree's: each numeric segment merged into
    the one before it (``layer1.0`` -> ``layer1_0``, ``features.0.0`` ->
    ``features_0_0``), except for the architectures in ``_UNSPLIT_ARCHS``."""
    if arch in _UNSPLIT_ARCHS:
        return list(segments)
    out: list[str] = []
    for seg in segments:
        if seg.isdigit() and out:
            out[-1] += f'_{seg}'
        else:
            out.append(seg)
    return out


def flax_from_state_dict(state: Mapping[str, torch.Tensor],
                         arch: str | None = None) -> dict[str, Any]:
    """{torch name: tensor} -> the JAX package's parameter tree (nested dicts
    of numpy arrays): OIHW conv weights become HWIO ``kernel`` leaves,
    ``[out, in]`` linear weights ``[in, out]``, BN entries
    ``scale``/``bias``/``mean``/``var``; int8 codes keep their dtype, every
    float leaf is float32.  BN step counters are dropped.  The inverse of
    ``state_dict_from_flax(tree, arch)``."""
    tree: dict[str, Any] = {}
    for name, t in state.items():
        if name.endswith('.num_batches_tracked'):
            continue
        *segments, leaf = name.split('.')
        v = t.detach().cpu().numpy()
        if v.dtype != np.int8:
            v = v.astype(np.float32)
        if leaf == 'weight' and v.ndim == 4:
            key, v = 'kernel', v.transpose(2, 3, 1, 0)   # OIHW -> HWIO
        elif leaf == 'weight' and v.ndim == 2:
            key, v = 'kernel', v.T                       # [out, in] -> [in, out]
        elif leaf in _FLAX_LEAF_NAMES:
            key = _FLAX_LEAF_NAMES[leaf]
        else:
            raise ValueError(f'{name}: no JAX counterpart for a {v.ndim}-D {leaf!r}')
        node = tree
        for seg in _flax_segments(segments, arch):
            node = node.setdefault(seg, {})
        node[key] = np.ascontiguousarray(v)
    return tree
