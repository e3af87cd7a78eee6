"""Precomputed per-site quantization parameters ("frozen qparams").

Port of ``cnn_quantization_tpu/engine/qparams.py``.  In use-stats mode every
input of the quantizer decision (alpha, delta, offset, bit allocation) is a
function of the calibration artifact alone; here it is resolved once into
(delta, offset, qmax) per site, and the eval forward applies one fake-quant
kernel per site with no per-batch statistics work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..ops import aciq, quant_math
from ..ops.bit_alloc import get_bits_alloc_fixed_target
from ..ops.kernels import fake_quant as fq
from ..ops.quantizer import QuantConfig
from ..utils.device import as_f32, resolve_device
from .context import CHANNEL_AXIS, QuantizeContext, Site, TapContext


class RecordingContext(TapContext):
    """Records (site, shape) pairs during a forward on the meta device."""

    mode = 'record'

    def __init__(self):
        self.sites: list[tuple[Site, tuple[int, ...]]] = []

    def tap(self, x, site: Site):
        self.sites.append((site, tuple(x.shape)))
        return x


def discover_sites(model: torch.nn.Module, input_shape) -> list[tuple[Site, tuple[int, ...]]]:
    """Run the model on the ``meta`` device, the counterpart of
    ``jax.eval_shape``: no FLOPs and no device memory.  ``input_shape`` is
    NCHW; the recorded shapes are NCHW."""
    ctx = RecordingContext()
    meta_state = {k: torch.empty_like(v, device='meta')
                  for k, v in model.state_dict().items()}
    x = torch.empty(input_shape, dtype=torch.float32, device='meta')
    torch.func.functional_call(model, meta_state, (x, ctx))
    return ctx.sites


@dataclasses.dataclass(frozen=True)
class SiteQParams:
    delta: Any
    offset: Any
    qmax: Any
    per_channel: bool  # broadcast over the channel axis (dim 1)


def freeze_qparams(policy, stats: Mapping[str, Any],
                   sites: list[tuple[Site, tuple[int, ...]]],
                   ignore_ids: tuple[str, ...] = (), *,
                   device=None) -> dict[str, SiteQParams]:
    """(delta, offset, qmax) per site from the stats artifact, by evaluating
    the tensor-independent branches of the quantizer dispatch once; the
    results are float32 tensors on ``device`` (``None``: the card).  Sites
    whose config needs the live tensor (mid-tread, the avgpool pcq_w quirk)
    stay dynamic."""
    dev = resolve_device(device)
    qctx = QuantizeContext(policy, stats=stats, ignore_ids=ignore_ids)
    out: dict[str, SiteQParams] = {}
    for site, shape in sites:
        cfg = qctx.config_for(site)
        if cfg is None or cfg.mtd_quant:
            continue
        site_stats = qctx.site_stats(site, cfg)
        if site_stats is None:
            continue
        qp = _extract_affine(cfg, site, site_stats, shape, dev)
        if qp is not None:
            out[site.id] = qp
    return out


def _extract_affine(cfg: QuantConfig, site: Site, site_stats, shape, dev):
    """(delta, offset, qmax) from the stats-only parts of
    quantize_activation's dispatch.  ``shape`` is NCHW."""
    half = cfg.force_positive or site.half_range
    # 4-D with H*W > 1: H and W are dims 2 and 3 in NCHW
    ndim_ok = len(shape) == 4 and (shape[2] > 1 or shape[3] > 1)
    per_channel_ok = cfg.pcq_a and ndim_ok

    def stat(name, kind='mean'):
        return as_f32(site_stats[f'{kind}_{name}'], dev)

    def has(name, kind='mean'):
        return f'{kind}_{name}' in site_stats

    def act_bit_alloc():
        if not (cfg.bit_alloc_act and cfg.num_bits <= 4):
            return None
        prior = 'std' if cfg.bit_alloc_prior == 'gaus' else 'b'
        if not has(prior):
            return None
        return get_bits_alloc_fixed_target(stat(prior), cfg.target_act(),
                                           cfg.bit_alloc_round)

    def scalar_qmax():
        return as_f32(cfg.qmax, dev)

    if cfg.kld:
        if not has('kld_th'):
            return None
        delta, offset = quant_math.alpha_to_delta_offset(
            stat('kld_th'), stat('max'), stat('min'), stat('mean'), half_range=half)
        return SiteQParams(delta, offset, scalar_qmax(), False)

    if cfg.clipping != 'no':
        if not (has('min') and has('max') and has('mean')):
            return None
        min_v, max_v, mean_v = stat('min'), stat('max'), stat('mean')
        pc = per_channel_ok and min_v.ndim > 0 and min_v.shape[0] > 1
        if cfg.clipping == 'laplace':
            if not has('b'):
                return None
            b = stat('b')
            if cfg.bit_alloc_act and pc and cfg.num_bits <= 4:
                alpha = aciq.alpha_laplace(b, act_bit_alloc(), half_range=half)
            else:
                alpha = aciq.alpha_laplace(b, cfg.num_bits, half_range=half)
        elif cfg.clipping == 'gaus':
            if not has('std'):
                return None
            alpha = aciq.alpha_gaus(stat('std'), cfg.num_bits, half_range=half)
        elif cfg.clipping.endswith('std'):
            if not has('std'):
                return None
            alpha = aciq.alpha_pstd(stat('std'), float(cfg.clipping[:-3]))
        elif cfg.clipping == 'mix':
            if not all(has(k) for k in ('mse_laplace', 'mse_gaus', 'mse_lowp', 'b', 'std')):
                return None
            a_l = aciq.alpha_laplace(stat('b'), cfg.num_bits, half_range=half)
            a_g = aciq.alpha_gaus(stat('std'), cfg.num_bits, half_range=half)
            a_p = (stat('max') - stat('min')) / 2.0
            alpha = torch.where(stat('mse_gaus') < stat('mse_laplace'), a_g, a_l)
            alpha = torch.where(stat('mse_lowp') < stat('mse_gaus'), a_p, alpha)
        else:
            return None
        delta, offset = quant_math.alpha_to_delta_offset(alpha, max_v, min_v,
                                                         mean_v, half_range=half)
        if pc:
            bits = act_bit_alloc()
            qmax = quant_math.qmax_for_bits(bits) if bits is not None else scalar_qmax()
            return SiteQParams(delta, offset, qmax, True)
        return SiteQParams(delta, offset, scalar_qmax(), False)

    if cfg.pcq_w:
        # default-quantizer pcq_w branch (avgpool quirk): per-SAMPLE min/max of
        # the live tensor (int_quantizer.py:453-461), so it cannot be frozen
        return None

    if per_channel_ok:
        if not has('max', cfg.stats_kind):
            return None
        max_v = stat('max', cfg.stats_kind)
        if max_v.ndim > 0:
            if half:
                min_v = torch.zeros_like(max_v)
            elif has('min', cfg.stats_kind):
                min_v = stat('min', cfg.stats_kind)
            else:
                return None
            bits = act_bit_alloc()
            qmax = quant_math.qmax_for_bits(bits) if bits is not None else scalar_qmax()
            return SiteQParams(max_v - min_v, min_v, qmax, True)
        # the per-channel artifact had no entry: scalar fallback below

    kmin, kmax = ('mean', 'mean') if cfg.stats_kind == 'mean' else ('min', 'max')
    if not (has('min', kmin) and has('max', kmax)):
        return None
    delta, offset = quant_math.minmax_delta_offset(stat('min', kmin), stat('max', kmax),
                                                   half_range=half)
    return SiteQParams(delta, offset, scalar_qmax(), False)


def apply_frozen(x, qp: SiteQParams):
    """One fake-quant kernel launch with the frozen parameters."""
    return fq.fake_quant_fused(x, qp.delta, qp.offset, qp.qmax,
                               channel_dim=CHANNEL_AXIS if qp.per_channel else None)
