"""A (data, model) grid of ranks over ``torch.distributed``, and the sharding
rule of the parameters.

Port of ``cnn_quantization_tpu/parallel/mesh.py``.  The reference's only
parallelism is single-host ``torch.nn.DataParallel`` (inference_sim.py:159,
196-200); the JAX package runs SPMD over a 2-D device mesh and leaves the
collectives to GSPMD.  Here the ranks of the process group form the grid,
``rank = data_index * model + model_index``, and the collectives are
explicit:

  * ``data`` axis: the evaluation batch is split across it (DP); counts,
    the loss and the calibration statistics are all-reduced over this
    rank's column of the grid (``data_group``);
  * ``model`` axis: per-output-channel weights and their per-channel
    vectors are split over output channels (TP); each sharded conv or linear
    computes its slice of the output channels and all-gathers them over
    this rank's row (``model_group``, ``gather_channels``), after its own
    epilogue.  Activation qparams and scales belong to the full tensor the
    gather gives back, so they stay replicated.

Without an initialised process group the mesh is 1x1 and carries no group:
every path is the single-device one.  The backend is the process group's:
NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid and its two groups."""
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None    # this rank's column: the ranks of one model index
    model_group: Any = None   # this rank's row: the ranks of one data index

    @property
    def shape(self) -> dict[str, int]:
        return {'data': self.data, 'model': self.model}


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(data: int | None = None, model: int | None = None) -> Mesh:
    """The (data, model) grid of the default process group's ranks.
    Defaults: every rank on the data axis.  Without a process group only the
    1x1 mesh exists."""
    rank, n = world()
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f'mesh {data}x{model} does not fit {n} rank(s)'
                         + ('' if n > 1 else ': a larger mesh needs a process group '
                            '(launch under torchrun)'))
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh()
    d_idx, m_idx = divmod(rank, model)
    data_group = model_group = None
    # every rank creates every group, in one order (dist.new_group's contract)
    for d in range(data):
        group = dist.new_group([d * model + m for m in range(model)])
        if d == d_idx:
            model_group = group
    for m in range(model):
        group = dist.new_group([d * model + m for d in range(data)])
        if m == m_idx:
            data_group = group
    return Mesh(data, model, d_idx, m_idx, data_group, model_group)


def _sharded_modules(model: torch.nn.Module, model_size: int):
    """Module paths of the convs and linears whose outputs split over the
    model axis: one group, and ``model_size`` dividing their output channels.
    A grouped or depthwise conv stays replicated: a slice of its outputs
    would need a slice of its input channels as well."""
    from ..models.layers import QConv, QLinear
    for name, m in model.named_modules():
        if isinstance(m, QConv) and m.groups == 1 and m.features % model_size == 0 \
                and m.features >= model_size:
            yield name
        elif isinstance(m, QLinear) and m.weight.shape[0] % model_size == 0 \
                and m.weight.shape[0] >= model_size:
            yield name


def param_sharding(mesh: Mesh, params: Mapping[str, torch.Tensor],
                   model: torch.nn.Module) -> dict[str, str | None]:
    """{name: 'model' or None}: the weight of a conv or linear that
    ``_sharded_modules`` names, and its per-output-channel vectors (``bias``,
    the serving tree's ``w_scale``), split over the model axis along axis 0
    (OIHW, ``[out, in]``, ``[out]``), the JAX rule (``mesh.py:41-52``) in
    torch's layout; every other entry replicated."""
    spec = {k: None for k in params}
    if mesh.model == 1:
        return spec
    for path in _sharded_modules(model, mesh.model):
        for leaf in ('weight', 'bias', 'w_scale'):
            key = f'{path}.{leaf}'
            if key in params and params[key].ndim >= 1:
                spec[key] = 'model'
    return spec


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """This rank's parameters: each sharded entry's slice of output channels
    as a tensor of its own (a fresh, aligned allocation in the entry's memory
    format, never a strided view, as the int8 kernels' TMA descriptors need),
    every other entry as it is."""
    spec = param_sharding(mesh, params, model)
    out = {}
    for k, v in params.items():
        if spec[k] == 'model':
            per = v.shape[0] // mesh.model
            v = v[mesh.model_index * per:(mesh.model_index + 1) * per].clone()
        out[k] = v
    return out


def shard_batch(mesh: Mesh, images, labels):
    """This rank's contiguous slice of a global batch along the data axis."""
    n = images.shape[0]
    if n % mesh.data:
        raise ValueError(f'a batch of {n} does not split over a data axis of {mesh.data}')
    per = n // mesh.data
    sl = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    return images[sl], labels[sl]


def gather_channels(y: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """All-gather each rank's slice of channels over ``group`` and
    concatenate them in rank order along ``dim``.  The list form of
    ``all_gather`` (gloo has no ``all_gather_into_tensor``).  A 4-D NCHW
    slice travels as its NHWC view, which a channels_last tensor holds
    contiguously, and comes back channels_last."""
    if y.ndim == 4 and dim == 1:
        nhwc = y.permute(0, 2, 3, 1).contiguous()
        parts = [torch.empty_like(nhwc) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, nhwc, group=group)
        return torch.cat(parts, dim=3).permute(0, 3, 1, 2)
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=dim)
