"""Functional quantizer: port of ``cnn_quantization_tpu/ops/quantizer.py``
(the reference's ``IntQuantizer`` dispatch, int_quantizer.py:92-122).

Quantization is a function of (tensor, QuantConfig, site flags, optional
calibration stats dict).  Stats dicts are keyed ``"{kind}_{stat}"`` (e.g.
``"mean_b"``) and hold scalars or per-channel vectors.  Activations are NCHW
(``channel_axis=1``), weights OIHW (``out_axis=0``).

Every fake-quant goes through the hand-written CUDA kernel's wrappers
(``ops/kernels/fake_quant.py``); on a CPU tensor they run the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..utils.device import as_f32
from . import aciq
from .bit_alloc import get_bits_alloc_fixed_target
from .entropy import shannon_entropy
from .kernels import fake_quant as fq
from .quant_math import (alpha_to_delta_offset, minmax_delta_offset,
                         qmax_for_bits, quantize_codes)
from .stats import act_stats, act_stats_per_channel, weight_stats_per_channel


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static per-quantizer configuration (the reference's qparams dict plus
    the per-tag overrides of inference_quantization_manager.py:407-476)."""
    num_bits: int = 8
    clipping: str = 'no'          # no | laplace | gaus | exp | <p>std | mix
    stats_kind: str = 'mean'      # aggregation kind consulted for min/max stats
    kld: bool = False
    pcq_w: bool = False           # per-(output-)channel weights
    pcq_a: bool = False           # per-channel activations
    bit_alloc_act: bool = False
    bit_alloc_weight: bool = False
    bit_alloc_round: bool = True  # CLI default -bam round
    bit_alloc_prior: str = 'gaus'  # gaus -> std, laplace -> b
    bit_alloc_target_act: float | None = None
    bit_alloc_target_weight: float | None = None
    bcorr_act: bool = False
    bcorr_weight: bool = False
    vcorr_weight: bool = False
    measure_entropy: bool = False
    mtd_quant: bool = False
    force_positive: bool = False  # arch-level fused relu (vgg/alexnet/...)
    stats_per_channel: bool = False  # consult the per-channel stats artifact
    stochastic: bool = False      # stochastic rounding on activation tags

    @property
    def qmax(self) -> float:
        return 2.0 ** self.num_bits - 1.0

    def target_act(self) -> float:
        return self.bit_alloc_target_act if self.bit_alloc_target_act is not None else self.num_bits

    def target_weight(self) -> float:
        return self.bit_alloc_target_weight if self.bit_alloc_target_weight is not None else self.num_bits


_MID_TREAD = ('mid-tread quantization (ops/mid_tread.py) is not ported yet: '
              'ROADMAP Queue 1 item 1')
_KLD = ('KLD clipping (calib/kld.py and the native threshold sweep) is not '
        'ported yet: ROADMAP Queue 1 item 8')


def _stat(site_stats: Mapping[str, Any], stat: str, kind: str, device):
    return as_f32(site_stats[f'{kind}_{stat}'], device)


def _is_spatial(x, channel_axis):
    """Per-channel-activation condition: 4-D with H*W > 1 (int_quantizer.py:110)."""
    if x.ndim != 4:
        return False
    spatial = [x.shape[i] for i in range(1, 4) if i != channel_axis % 4]
    return spatial[0] > 1 or spatial[1] > 1


def _act_bit_alloc(cfg: QuantConfig, x, site_stats, channel_axis):
    """Per-channel activation bit widths (or None), gated on bits <= 4
    (int_quantizer.py:430-438)."""
    if not (cfg.bit_alloc_act and cfg.num_bits <= 4):
        return None
    prior = 'std' if cfg.bit_alloc_prior == 'gaus' else 'b'
    if site_stats is not None:
        disp = _stat(site_stats, prior, 'mean', x.device)
    else:
        disp = act_stats_per_channel(x, [prior], channel_axis=channel_axis)[prior]
    return get_bits_alloc_fixed_target(disp, cfg.target_act(), cfg.bit_alloc_round)


def _alpha(cfg: QuantConfig, x, site_stats, *, half_range: bool,
           per_channel: bool, channel_axis: int):
    """Clip value per the configured clipping type (int_quantizer.py:227-325)."""
    half = cfg.force_positive or half_range
    dev = x.device

    def online(stat):
        if per_channel:
            return act_stats_per_channel(x, [stat], channel_axis=channel_axis)[stat]
        return act_stats(x, [stat])[stat]

    def stat(name):
        return _stat(site_stats, name, 'mean', dev) if site_stats is not None else online(name)

    clip = cfg.clipping
    if clip == 'laplace':
        b = stat('b')
        if cfg.bit_alloc_act and per_channel and cfg.num_bits <= 4:
            bits = _act_bit_alloc(cfg, x, site_stats, channel_axis)
            return aciq.alpha_laplace(b, bits, half_range=half)
        return aciq.alpha_laplace(b, cfg.num_bits, half_range=half)
    if clip == 'gaus':
        return aciq.alpha_gaus(stat('std'), cfg.num_bits, half_range=half)
    if clip == 'exp':
        # mean_abs exists only in the per-tensor stat set; fall back online
        if site_stats is not None and 'mean_mean_abs' in site_stats:
            m = _stat(site_stats, 'mean_abs', 'mean', dev)
        else:
            m = online('mean_abs')
        return aciq.alpha_exp(m, cfg.num_bits)
    if clip.endswith('std'):
        return aciq.alpha_pstd(stat('std'), float(clip[:-len('std')]))
    if clip == 'mix':
        # the min-MSE prior per site from calibration-time error stats
        # (int_quantizer.py:310-323); requires stats
        s = {k: _stat(site_stats, k, 'mean', dev)
             for k in ('mse_laplace', 'mse_gaus', 'mse_lowp', 'b', 'std', 'max', 'min')}
        a_laplace = aciq.alpha_laplace(s['b'], cfg.num_bits, half_range=half)
        a_gaus = aciq.alpha_gaus(s['std'], cfg.num_bits, half_range=half)
        a_lowp = (s['max'] - s['min']) / 2.0
        alpha = torch.where(s['mse_gaus'] < s['mse_laplace'], a_gaus, a_laplace)
        return torch.where(s['mse_lowp'] < s['mse_gaus'], a_lowp, alpha)
    raise ValueError(f'unknown clipping {clip!r}')


def _apply_fake_quant(x, cfg: QuantConfig, delta, offset, qmax, *,
                      channel_axis=None, seed: int = 0):
    """The affine fake-quant kernel, stochastic when the config asks for it."""
    per_channel = channel_axis is not None and any(
        getattr(v, 'ndim', 0) > 0 for v in (delta, offset, qmax))
    return fq.fake_quant_fused(x, delta, offset, qmax,
                               channel_dim=channel_axis if per_channel else None,
                               stochastic=cfg.stochastic, seed=seed)


def _fake_quant_with_alloc(x, cfg: QuantConfig, delta, offset, bit_alloc,
                           *, channel_axis, seed: int = 0):
    """Fake-quant with optional per-channel bit widths, optionally measuring
    code entropy (int_quantizer.py:442-448, 469-474)."""
    qmax = cfg.qmax if bit_alloc is None else qmax_for_bits(bit_alloc)
    out = _apply_fake_quant(x, cfg, delta, offset, qmax,
                            channel_axis=channel_axis, seed=seed)
    ent = None
    if cfg.measure_entropy:
        codes, _ = quantize_codes(x, delta, offset, qmax, channel_axis=channel_axis)
        ent = shannon_entropy(codes)
    return out, ent


def quantize_activation(x, cfg: QuantConfig, *, half_range: bool = False,
                        site_stats: Mapping[str, Any] | None = None,
                        channel_axis: int = 1, tag: str = 'activation',
                        seed: int = 0):
    """Quantize an activation tensor; returns (tensor, aux) where aux may
    carry {'entropy': scalar}.

    The dispatch order of IntQuantizer.__call__ (int_quantizer.py:92-122):
    kld -> clipping -> pcq_w (ahead of pcq_a even for activations) ->
    per-channel minmax -> per-tensor minmax.  ``seed`` keys the
    stochastic-rounding noise (the caller derives it per site)."""
    half = cfg.force_positive or half_range
    per_channel_ok = cfg.pcq_a and _is_spatial(x, channel_axis)
    aux: dict[str, Any] = {}
    dev = x.device

    if cfg.kld:
        raise NotImplementedError(_KLD)

    if cfg.clipping != 'no':
        if cfg.mtd_quant:
            raise NotImplementedError(_MID_TREAD)

        # gemmlowp + ACIQ clipping (int_quantizer.py:327-359)
        if site_stats is not None:
            min_v, max_v, mean_v = (_stat(site_stats, k, 'mean', dev)
                                    for k in ('min', 'max', 'mean'))
        elif per_channel_ok:
            s = act_stats_per_channel(x, ['min', 'max'], channel_axis=channel_axis)
            mean_v = act_stats_per_channel(x, ['mean'], channel_axis=channel_axis,
                                           avg_over_batch=True)['mean']
            min_v, max_v = s['min'], s['max']
        else:
            s = act_stats(x, ['min', 'max', 'mean'])
            min_v, max_v, mean_v = s['min'], s['max'], s['mean']

        if per_channel_ok and min_v.ndim > 0 and min_v.shape[0] > 1:
            alpha = _alpha(cfg, x, site_stats, half_range=half_range,
                           per_channel=True, channel_axis=channel_axis)
            delta, offset = alpha_to_delta_offset(alpha, max_v, min_v, mean_v,
                                                  half_range=half)
            bit_alloc = _act_bit_alloc(cfg, x, site_stats, channel_axis)
            out, ent = _fake_quant_with_alloc(x, cfg, delta, offset, bit_alloc,
                                              channel_axis=channel_axis, seed=seed)
            if ent is not None:
                aux['entropy'] = ent
            return out, aux

        alpha = _alpha(cfg, x, site_stats, half_range=half_range,
                       per_channel=False, channel_axis=channel_axis)
        delta, offset = alpha_to_delta_offset(alpha, max_v, min_v, mean_v,
                                              half_range=half)
        return _apply_fake_quant(x, cfg, delta, offset, cfg.qmax, seed=seed), aux

    if cfg.pcq_w:
        # The reference routes pcq_w AHEAD of pcq_a even for activations
        # (int_quantizer.py:101-106).  Reachable through the default quantizer
        # (the avgpool tag-as-id quirk, engine/policy.py), which then runs
        # gemmlowpQuantizeWeightsPerChannel on the activation: per-dim-0, i.e.
        # per-SAMPLE, min/max over the flattened rest (int_quantizer.py:453-476).
        t = x.reshape(x.shape[0], -1)
        min_v = torch.amin(t, dim=1)
        max_v = torch.amax(t, dim=1)
        bit_alloc = None
        if cfg.bit_alloc_weight and cfg.num_bits <= 4:
            std = torch.std(t.float(), dim=1, correction=1)
            bit_alloc = get_bits_alloc_fixed_target(
                std, cfg.target_weight(), cfg.bit_alloc_round)
        out, ent = _fake_quant_with_alloc(t, cfg, max_v - min_v, min_v,
                                          bit_alloc, channel_axis=0, seed=seed)
        if ent is not None:
            aux['entropy'] = ent
        return out.reshape(x.shape), aux

    if per_channel_ok:
        # per-channel min/max (int_quantizer.py:409-451)
        if half:
            min_v = None
        elif site_stats is not None:
            min_v = _stat(site_stats, 'min', cfg.stats_kind, dev)
        else:
            min_v = act_stats_per_channel(x, ['min'], channel_axis=channel_axis)['min']
        if site_stats is not None:
            max_v = _stat(site_stats, 'max', cfg.stats_kind, dev)
        else:
            max_v = act_stats_per_channel(x, ['max'], channel_axis=channel_axis)['max']
        if min_v is None:
            min_v = torch.zeros_like(max_v)
        bit_alloc = _act_bit_alloc(cfg, x, site_stats, channel_axis)
        out, ent = _fake_quant_with_alloc(x, cfg, max_v - min_v, min_v, bit_alloc,
                                          channel_axis=channel_axis, seed=seed)
        if ent is not None:
            aux['entropy'] = ent
        return out, aux

    # per-tensor min/max (int_quantizer.py:361-379)
    if site_stats is not None:
        kmin, kmax = ('mean', 'mean') if cfg.stats_kind == 'mean' else ('min', 'max')
        min_v = _stat(site_stats, 'min', kmin, dev)
        max_v = _stat(site_stats, 'max', kmax, dev)
    else:
        avg = ('activation' in tag) and ('classifier' not in tag)
        s = act_stats(x, ['min', 'max'], avg_over_batch=avg)
        min_v, max_v = s['min'], s['max']
    delta, offset = minmax_delta_offset(min_v, max_v, half_range=half)
    if cfg.stochastic:
        # stochastic rounding replaces the deterministic native kernel (where
        # the reference's noise tensor would apply, gemmlowp.cu:16)
        return _apply_fake_quant(x, cfg, delta, offset, cfg.qmax, seed=seed), aux
    # the reference's per-tensor min/max path runs through its native kernel
    # (int_quantizer.py:379): exact-affine when the range does not straddle 0
    return fq.fake_quant_kernel_semantics_fused(x, delta, offset, cfg.num_bits), aux


def quantize_weight(w, cfg: QuantConfig, *, out_axis: int = 0):
    """Quantize a weight per output channel (or per tensor): the pcq_w
    branch of IntQuantizer.__call__ plus gemmlowpQuantizeWeightsPerChannel
    (int_quantizer.py:104-109, 453-476), and the per-tensor fallthrough.
    Bias/variance correction is the engine's.  Returns (w_q, aux)."""
    aux: dict[str, Any] = {}
    w = w.contiguous()
    if cfg.pcq_w:
        if cfg.mtd_quant:
            raise NotImplementedError(_MID_TREAD)
        s = weight_stats_per_channel(w, ['min', 'max'], out_axis=out_axis)
        min_v, max_v = s['min'], s['max']
        bit_alloc = None
        if cfg.bit_alloc_weight and cfg.num_bits <= 4:
            std = weight_stats_per_channel(w, ['std'], out_axis=out_axis)['std']
            bit_alloc = get_bits_alloc_fixed_target(std, cfg.target_weight(),
                                                    cfg.bit_alloc_round)
        out, ent = _fake_quant_with_alloc(w, cfg, max_v - min_v, min_v, bit_alloc,
                                          channel_axis=out_axis)
        if ent is not None:
            aux['entropy'] = ent
        return out, aux

    # per-tensor min/max fallthrough (tag 'weight' never batch-averages);
    # the reference runs it through its native kernel (int_quantizer.py:379)
    s = act_stats(w, ['min', 'max'])
    delta, offset = minmax_delta_offset(s['min'], s['max'],
                                        half_range=cfg.force_positive)
    return fq.fake_quant_kernel_semantics_fused(w, delta, offset, cfg.num_bits), aux
