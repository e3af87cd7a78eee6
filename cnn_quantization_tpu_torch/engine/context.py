"""Quantization tap context threaded through the model's forward.

Port of ``cnn_quantization_tpu/engine/context.py``.  Each layer calls
``ctx.tap(out, site)`` on its output; the context is

  * ``TapContext``         - off: the tensor passes unchanged;
  * ``ServingInt8Context`` - true-int8 serving: taps are identity, the convs
                             and linears quantize their *inputs* and run int8
                             arithmetic (models/layers.py);
  * ``CollectContext``     - computes calibration statistics of the tensor;
  * ``QuantizeContext``    - applies the per-tag fake-quant policy (optionally
                             from a calibration-stats dict or frozen qparams).

A fresh context is made for every forward.  Activations are NCHW, so the
channel axis is 1 throughout.  Under a (data, model) mesh
(``parallel/mesh.py``) the context also carries this rank's two process
groups: ``data_group``, over which the forward's activation statistics
reduce (``ops/stats.global_over``), and ``model_group``, over which a conv or
linear whose weight holds a slice of its output channels all-gathers its
output (``models/layers.py``).  Both are None on one device.
"""

from __future__ import annotations

import dataclasses
import math
import types
import zlib
from typing import Any, Mapping

import torch
import torch.distributed

from ..ops import bias_corr
from ..ops.kernels import fake_quant as fq
from ..ops.quantizer import QuantConfig, quantize_activation
from ..ops.stats import act_stats, act_stats_per_channel, data_group, global_sum
from .policy import QuantPolicy

CHANNEL_AXIS = 1

# Statistics collected per site by the per-tensor manager
# (statistic_manager.py:16, minus the error/kld columns).
PER_TENSOR_STATS = ('max', 'min', 'std', 'mean', 'kurtosis', 'mean_abs', 'b')
# Per-channel manager stats (statistic_manager_perchannel.py:18).
PER_CHANNEL_STATS = ('max', 'min', 'std', 'mean', 'kurtosis', 'b', 'std_pos')


@dataclasses.dataclass(frozen=True)
class Site:
    """Static description of one quantization site (a layer output)."""
    id: str                      # e.g. 'conv12_activation', 'maxpool0_out'
    tag: str                     # policy tag, e.g. 'activation'
    half_range: bool = False     # the reference's before_relu marking
    kind: str = 'conv'           # conv | linear | bn | maxpool | avgpool


class TapContext:
    """Base: quantization disabled.  It declares, at their off values, what
    the layers read of the true-int serving path, which
    ``ServingInt8Context`` sets."""

    mode = 'off'
    data_group = None
    model_group = None
    int8_serving = False
    act_scales: Mapping[str, Any] = types.MappingProxyType({})
    act_bits = weight_bits = 8
    calibrate = False
    packed: bool | tuple = False

    def tap(self, x, site: Site):
        return x

    def record_scale(self, site_id: str, scale):
        """A dynamic serving scale, kept for calibration; off, nothing."""

    def record_input_stats(self, site_id: str, x, groups: int = 1):
        """A serving input's calibration statistics; off, nothing."""

    def finalize(self) -> dict[str, Any]:
        return {}


def percentile_rows(rows: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of each row of ``rows`` [G, n], linearly
    interpolated between the two nearest order statistics as
    ``jnp.percentile`` does.  ``torch.quantile`` refuses inputs above 16 M
    elements (a stage-1 activation at batch 64 has 51 M), so the rows are
    sorted; calibration only, never on the hot path."""
    n = rows.shape[-1]
    pos = min(max(q, 0.0), 100.0) / 100.0 * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    ordered = torch.sort(rows, dim=-1).values
    low, high = ordered[..., lo], ordered[..., hi]
    weight = torch.full((), pos - lo, dtype=rows.dtype, device=rows.device)
    return low * (1.0 - weight) + high * weight


class ServingInt8Context(TapContext):
    """True-int8 serving mode: convs and linears run quantize -> int8 product
    (int32 accumulate) -> dequant (models/layers.py, ops/kernels/int_conv.py);
    taps are identity since activations are quantized at the conv inputs.

    ``act_scales``: frozen per-site input scales (site id -> float32 device
    scalar, or an ``[in_ch]`` vector for grouped convs) from calibration; a
    site without one falls back to dynamic abs-max quantization, whose scale
    is recorded so a calibration run can freeze it
    (``QuantEngine.freeze_serving_scales``).  ``act_bits``/``weight_bits``
    below 8 narrow the code grid; the codes still travel as int8 through the
    same kernels.  ``calibrate`` also records per-input statistics (abs-max,
    the requested |x| percentile, Laplace b = E|x|) so the frozen scales can
    be clipped instead of stretched by outliers.  ``packed`` (True, or a tuple
    of 1-based ResNet stages) asks a Bottleneck trunk for the W4A4 packed
    orchestration (models/resnet.py); it engages only with scales frozen with
    ``packed=True``."""

    mode = 'serving_int8'
    int8_serving = True

    def __init__(self, act_scales: Mapping[str, Any] | None = None,
                 act_bits: int = 8, weight_bits: int = 8,
                 calibrate: bool = False, percentile: float = 99.99,
                 packed: bool | tuple = False):
        self.act_scales = dict(act_scales or {})
        self.packed = packed
        self.act_bits = act_bits
        self.weight_bits = weight_bits
        self.calibrate = calibrate
        self.percentile = percentile
        self.recorded: dict[str, Any] = {}

    def record_scale(self, site_id: str, scale):
        self.recorded[site_id] = scale

    def record_input_stats(self, site_id: str, x, groups: int = 1):
        """Calibration-time input statistics for scale freezing, of ``x`` in
        float32; nothing unless ``calibrate``.

        ``groups > 1`` (grouped/depthwise conv inputs, where the activation
        scale factors out of the integer sum per group) records per-group
        statistics repeated over each group's channels, so
        ``freeze_serving_scales`` freezes an ``[in_ch]`` scale vector that is
        constant within groups, the invariant ``int8_conv``'s epilogue
        mapping relies on."""
        if not self.calibrate:
            return
        xf32 = x.float()
        per_group = groups > 1 and xf32.ndim == 4
        if per_group:
            n, c, h, w = xf32.shape
            per = c // groups
            rows = xf32.abs().reshape(n, groups, per, h, w).permute(1, 0, 2, 3, 4).reshape(
                groups, -1)
        else:
            rows = xf32.abs().reshape(1, -1)
        # the *requested* percentile, exactly
        stats = {'absmax': rows.amax(dim=1), 'pq': percentile_rows(rows, self.percentile),
                 'b': rows.mean(dim=1)}
        for name, v in stats.items():
            self.recorded[f'{site_id}/{name}'] = v.repeat_interleave(per) if per_group else v[0]

    def finalize(self):
        return dict(self.recorded)


class CollectContext(TapContext):
    """Collect calibration statistics (reference StatsMode.collect_stats).

    ``collected[site_id][stat]`` holds device tensors; the calibrator
    aggregates them across batches.  ``per_channel=True`` mirrors
    StatisticManagerPerChannel: 4-D spatial tensors only, per channel, with
    the scalar stats always collected as well."""

    mode = 'collect'

    def __init__(self, *, per_channel: bool, batch_avg: bool = False,
                 channel_axis: int = CHANNEL_AXIS, err_bits: int | None = None):
        self.per_channel = per_channel
        self.batch_avg = batch_avg
        self.channel_axis = channel_axis
        self.err_bits = err_bits
        self.collected: dict[str, dict[str, torch.Tensor]] = {}

    def tap(self, x, site: Site):
        force_global = 'classifier' in site.tag
        entry: dict[str, torch.Tensor] = {}
        xf = x.float()
        # per-tensor stats (statistic_manager.py:47-124); min/max optionally
        # batch-averaged, never for classifier sites
        pt = act_stats(xf, [s for s in PER_TENSOR_STATS if s not in ('min', 'max')])
        mm = act_stats(xf, ['min', 'max'],
                       avg_over_batch=self.batch_avg and not force_global)
        entry.update({f'scalar/{k}': v for k, v in {**pt, **mm}.items()})
        if self.err_bits is not None:
            entry.update({f'scalar/{k}': v for k, v in
                          _quant_error_stats(xf, self.err_bits).items()})

        if self.per_channel and xf.ndim == 4 and _spatial(xf, self.channel_axis):
            pc = act_stats_per_channel(
                xf, [s for s in PER_CHANNEL_STATS if s not in ('min', 'max')],
                channel_axis=self.channel_axis)
            pc.update(act_stats_per_channel(
                xf, ['min', 'max'], channel_axis=self.channel_axis,
                avg_over_batch=self.batch_avg and not force_global))
            entry.update({f'channel/{k}': v for k, v in pc.items()})

        self.collected[site.id] = entry
        return x

    def finalize(self):
        return dict(self.collected)


class QuantizeContext(TapContext):
    """Apply the fake-quant policy at every site (StatsMode.no_stats or
    use_stats, by whether ``stats`` is given)."""

    mode = 'quantize'

    def __init__(self, policy: QuantPolicy,
                 stats: Mapping[str, Mapping[str, Any]] | None = None,
                 ignore_ids: tuple[str, ...] = (),
                 channel_axis: int = CHANNEL_AXIS,
                 qparams: Mapping[str, Any] | None = None):
        self.policy = policy
        self.configs = policy.tag_configs()
        self.stats = stats
        self.ignore_ids = frozenset(ignore_ids) | frozenset(policy.default_ignore_ids())
        self.channel_axis = channel_axis
        self.qparams = qparams or {}
        self.aux: dict[str, Any] = {}

    def config_for(self, site: Site) -> QuantConfig | None:
        # The 8-bit ignore list only matches when a stat_id is passed, which
        # the reference's intercepting layers do ONLY in use-stats mode
        # (inference_quantization_manager.py:174-207 vs :549-556), so even the
        # automatic int4 'conv0_activation' entry does not fire without stats.
        use_ignore = self.stats is not None
        tag = 'ignored' if use_ignore and site.id in self.ignore_ids else site.tag
        return self.configs.get(tag)

    def site_stats(self, site: Site, cfg: QuantConfig):
        if self.stats is None or site.id not in self.stats:
            return None
        entry = self.stats[site.id]
        space = 'channel' if cfg.stats_per_channel else 'scalar'
        out = {k[len(space) + 1:]: v for k, v in entry.items()
               if k.startswith(space + '/')}
        # the per-channel manager has no entry for FC/1x1 sites: scalar fallback
        if not out:
            out = {k[len('scalar/'):]: v for k, v in entry.items()
                   if k.startswith('scalar/')}
        return out or None

    def tap(self, x, site: Site):
        cfg = self.config_for(site)
        if cfg is None or self.policy.qtype is None:
            return x
        stats = self.site_stats(site, cfg)
        if self.policy.rho_act is not None and site.tag.startswith('activation'):
            # fp32 statistical clip ahead of quantization (the reference's
            # activations_clipper, live here; clipping_manager.py:10-42)
            from ..ops.clippers import statistical_clip
            ss = stats if stats and 'mean_mean_abs' in stats and 'mean_std' in stats \
                else None
            x = statistical_clip(x, self.policy.rho_act, site_stats=ss)
        if site.id in self.qparams and not (cfg.measure_entropy or cfg.stochastic):
            # frozen fast path: one fused fake-quant, no per-batch stats
            from .qparams import apply_frozen
            out_q = apply_frozen(x, self.qparams[site.id])
            aux = {}
        else:
            # per-site stream for stochastic rounding: differs across layers,
            # the same across batches and processes (crc32, not the salted hash())
            seed = zlib.crc32(site.id.encode()) & 0x7FFFFFFF
            out_q, aux = quantize_activation(
                x, cfg, half_range=site.half_range, site_stats=stats,
                channel_axis=self.channel_axis, tag=site.tag, seed=seed)
        if 'entropy' in aux:
            self.aux[f'{site.id}/entropy'] = aux['entropy']
            self.aux[f'{site.id}/numel'] = x.numel()
        if cfg.bcorr_act and stats is not None and site.kind == 'conv':
            # activation bias correction needs the float tensor; the reference
            # applies it only in use-stats mode on conv outputs
            # (inference_quantization_manager.py:180-203)
            out_q = bias_corr.activation_bias_correction(
                x, out_q, channel_axis=self.channel_axis,
                pre_relu=site.half_range or cfg.force_positive)
        return out_q.to(x.dtype)

    def finalize(self):
        return dict(self.aux)


def _spatial(x, channel_axis):
    """H*W > 1 for a 4-D tensor whose channels sit at ``channel_axis``."""
    sp = [x.shape[i] for i in range(1, 4) if i != channel_axis % 4]
    return sp[0] > 1 or sp[1] > 1


def _quant_error_stats(xf, bits: int):
    """Per-prior quantization-error columns (mse_/cos_ lowp|gaus|laplace),
    which the reference reserves (statistic_manager.py:22-32) but never fills;
    they make 'mix' clipping work."""
    from ..ops import aciq
    from ..ops.quant_math import alpha_to_delta_offset, minmax_delta_offset

    flat = xf.reshape(-1)
    s = act_stats(flat, ['min', 'max', 'mean', 'std', 'b'])
    qmax = 2.0 ** bits - 1.0
    out = {}

    group = data_group()

    def add(name, delta, offset):
        xq = fq.fake_quant_fused(flat, delta, offset, qmax)
        err = flat - xq
        if group is None:
            out[f'mse_{name}'] = torch.mean(err * err)
            denom = torch.linalg.norm(flat) * torch.linalg.norm(xq) + 1e-12
            out[f'cos_{name}'] = torch.dot(flat, xq) / denom
        else:   # the global batch's, under data parallelism
            n = float(flat.numel() * torch.distributed.get_world_size(group))
            out[f'mse_{name}'] = global_sum(err * err) / n
            denom = torch.sqrt(global_sum(flat * flat)) * torch.sqrt(global_sum(xq * xq)) + 1e-12
            out[f'cos_{name}'] = global_sum(flat * xq) / denom

    d, o = minmax_delta_offset(s['min'], s['max'], half_range=False)
    add('lowp', d, o)
    a_g = aciq.alpha_gaus(s['std'], bits, half_range=False)
    d, o = alpha_to_delta_offset(a_g, s['max'], s['min'], s['mean'], half_range=False)
    add('gaus', d, o)
    a_l = aciq.alpha_laplace(s['b'], bits, half_range=False)
    d, o = alpha_to_delta_offset(a_l, s['max'], s['min'], s['mean'], half_range=False)
    add('laplace', d, o)
    return out
