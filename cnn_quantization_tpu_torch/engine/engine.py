"""QuantEngine: weight quantization and quantized forward passes.

Port of ``cnn_quantization_tpu/engine/engine.py`` (the reference's
``QuantizationManagerInference``, i_q_m.py:286-393) without the packed-int4
serving options (ROADMAP Queue 1 item 6).  Parameters are a ``state_dict``
(name -> tensor) in torchvision naming with OIHW conv and [out, in] linear
weights; a forward runs the model's module tree on them with
``torch.func.functional_call``, the counterpart of ``model.apply``.  A
serving-prepared tree (``prepare_serving_params``) holds int8 codes under the
weight names plus a ``<module>.w_scale`` entry each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bias_corr
from ..ops.aciq import ALPHA_LAPLACE
from ..ops.kernels.int_matmul import quantize_sym_int8
from ..ops.quantizer import quantize_weight
from ..utils.device import as_f32, nhwc_to_nchw
from .context import CollectContext, QuantizeContext, ServingInt8Context, TapContext
from .policy import QuantPolicy, parse_qtype_bits

_PACKED_LATER = ('packed-int4 serving is not ported yet: ROADMAP Queue 1 item 6 '
                 '(W4A4 packed serving)')


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Static per-architecture facts the engine needs."""
    arch: str
    fold_bn: bool = True
    input_size: int = 224
    # module paths whose weights stay 8-bit by name (inception stem,
    # inference_quantization_manager.py:360-362)
    eight_bit_weight_names: tuple[str, ...] = ()


def _weight_names(params: Mapping[str, torch.Tensor]):
    """Conv (4-D) and linear (2-D) ``*.weight`` entries; BN weights are 1-D."""
    return [k for k, v in params.items()
            if k.endswith('.weight') and v.ndim in (2, 4)]


class QuantEngine:
    def __init__(self, model: torch.nn.Module, policy: QuantPolicy, meta: ModelMeta,
                 stats: Mapping[str, Any] | None = None,
                 ignore_ids: tuple[str, ...] = ()):
        self.model = model
        self.policy = policy
        self.meta = meta
        self.stats = stats
        self.ignore_ids = tuple(ignore_ids)

    # ------------------------------------------------------------------
    # Weight quantization pass (reference quantize_model, i_q_m.py:352-393)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def quantize_params(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A new state dict with every conv/linear weight fake-quantized per
        the policy (one fake-quant kernel launch per weight)."""
        configs = self.policy.tag_configs()
        out = dict(params)
        if not configs:
            return out
        for name in _weight_names(params):
            kernel = params[name]
            path = name[:-len('.weight')]
            if kernel.ndim == 4:
                cfg = configs['weight']
                if cfg is not None:
                    in_ch = kernel.shape[1]  # OIHW
                    name8 = any(n in path for n in self.meta.eight_bit_weight_names)
                    if in_ch == 3 or name8:
                        # first layer / inception stem stay 8-bit
                        cfg = dataclasses.replace(cfg, num_bits=8)
            else:
                out_ch = kernel.shape[0]  # [out, in]
                cfg = configs['weight_classifier' if out_ch == 1000 else 'weight']
            if cfg is None:
                continue
            w_in = kernel
            if self.policy.rho_weight is not None:
                # fp32 ratio clip ahead of weight quantization (the reference's
                # weights_clipper, live here; clipping_manager.py:45-62); the
                # corrections below still target the ORIGINAL fp32 moments
                from ..ops.clippers import ratio_clip
                w_in = ratio_clip(kernel, self.policy.rho_weight)
            w_q, _ = quantize_weight(w_in, cfg, out_axis=0)
            if self.policy.var_corr_weight or self.policy.bias_corr_weight:
                w_q = bias_corr.weight_correction(
                    kernel, w_q, out_axis=0,
                    bias_corr=self.policy.bias_corr_weight,
                    var_corr=self.policy.var_corr_weight)
            out[name] = w_q.to(kernel.dtype)
        return out

    # ------------------------------------------------------------------
    # Step functions
    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _serving_bits(self) -> tuple[int, int]:
        """(activation bits, weight bits) of the serving grid: the policy's
        widths clamped to 8; the codes travel as int8 either way."""
        act = parse_qtype_bits(self.policy.qtype) if self.policy.qtype else 8
        weight = (parse_qtype_bits(self.policy.qweight)
                  if self.policy.qweight not in (None, 'f32') else 8)
        return min(act, 8), min(weight, 8)

    def make_forward(self, quantized: bool | str = True, qparams=None,
                     act_scales=None, packed: bool = False) -> Callable:
        """f(params, stats, images) -> (logits, aux).  ``images`` are NHWC, as
        the JAX package takes them; the model runs them as an NCHW
        channels_last view on its device.  ``stats`` is the calibration dict
        or None; ``qparams`` (from ``freeze_qparams``) enables the frozen path
        per site.  ``quantized='serving_int8'`` runs the true-integer path;
        ``act_scales`` (from ``freeze_serving_scales``) freezes its activation
        scales, removing the per-conv dynamic abs-max pass."""
        if packed is not False:
            raise NotImplementedError(_PACKED_LATER)
        serving = quantized == 'serving_int8'
        if serving:
            act_bits, weight_bits = self._serving_bits()
            # frozen scales live on the device from here on: no host-to-device
            # copy per forward
            scales = {k: as_f32(v, self.device) for k, v in (act_scales or {}).items()}

        @torch.no_grad()
        def fwd(params, stats, images):
            if serving:
                ctx = ServingInt8Context(act_scales=scales, act_bits=act_bits,
                                         weight_bits=weight_bits)
            elif quantized and self.policy.qtype is not None:
                ctx = QuantizeContext(self.policy, stats=stats,
                                      ignore_ids=self.ignore_ids, qparams=qparams)
            else:
                ctx = TapContext()
            x = nhwc_to_nchw(images, self.device)
            logits = torch.func.functional_call(self.model, params, (x, ctx))
            return logits, ctx.finalize()

        return fwd

    @torch.no_grad()
    def prepare_serving_params(self, params_q: Mapping[str, torch.Tensor], *,
                               s2d_stem: bool = False) -> dict[str, torch.Tensor]:
        """Offline weight quantization for true-int8 serving: conv and linear
        weights become int8 codes (same shape, a quarter of the bytes; 4-D
        codes in channels_last memory, K contiguous for the kernels) with a
        per-output-channel ``<module>.w_scale`` entry, so the serving forward
        quantizes no weight.  Numerics equal the in-call quantization (the
        same ``quantize_sym_int8`` call).  Convs quantize at
        ``min(qweight bits, 8)``, 8 bits for ``eight_bit_weight_names``;
        linears always at 8.

        The first conv (in_ch == 3) stays float and runs as the float conv.
        ``s2d_stem=True`` (BN-folded ResNet 7x7/2 stems, even input sizes)
        instead space-to-depth transforms it to an equivalent [O, 12, 4, 4]
        stride-1 kernel quantized to int8 (``s2d_stem_kernel``)."""
        _, wb = self._serving_bits()
        out = dict(params_q)
        for name in _weight_names(params_q):
            kernel = params_q[name]
            path = name[:-len('.weight')]
            if kernel.ndim == 4:
                if kernel.shape[1] == 3:
                    if not (s2d_stem and self.meta.fold_bn
                            and tuple(kernel.shape[1:]) == (3, 7, 7)):
                        continue  # the float first conv
                    kernel, bits = s2d_stem_kernel(kernel.float()), 8
                else:
                    name8 = any(n in path for n in self.meta.eight_bit_weight_names)
                    bits = 8 if name8 else wb
            else:
                bits = 8  # linear/classifier weights stay 8-bit (policy)
            codes, scale = quantize_sym_int8(kernel.float(), axis=0, bits=bits)
            if codes.ndim == 4:
                codes = codes.contiguous(memory_format=torch.channels_last)
            out[name] = codes
            out[f'{path}.w_scale'] = scale
        return out

    def freeze_serving_scales(self, params_q, batches, *, max_batches: int = 4,
                              mode: str = 'max', percentile: float = 99.99,
                              packed: bool = False) -> dict:
        """Calibrate frozen serving-int8 activation scales over a few batches.
        ``mode`` sets the per-site scale from the recorded input statistics:

          'max'        - max over batches of abs-max (the grid covers every
                         calibration value; one outlier stretches it);
          'percentile' - max over batches of the |x| ``percentile`` (any
                         value, used exactly): outlier tails are clipped;
          'aciq'       - ACIQ-Laplace optimal clip for the serving bit width,
                         alpha = c_bits * E|x|, never wider than abs-max.

        Returns {site id: float, or a float32 ``[in_ch]`` vector for grouped
        conv inputs}; ``linear*``, ``conv0_*`` and ``*:out`` sites always use
        the full int8 grid."""
        if packed is not False:
            raise NotImplementedError(_PACKED_LATER)
        if mode not in ('max', 'percentile', 'aciq'):
            raise ValueError(f'unknown serving calibration mode {mode!r}')
        act_bits, weight_bits = self._serving_bits()
        agg: dict[str, dict[str, list]] = {}
        with torch.no_grad():
            for i, (images, _) in enumerate(batches):
                if i >= max_batches:
                    break
                ctx = ServingInt8Context(act_bits=act_bits, weight_bits=weight_bits,
                                         calibrate=True, percentile=percentile)
                x = nhwc_to_nchw(images, self.device)
                torch.func.functional_call(self.model, params_q, (x, ctx))
                for key, v in ctx.finalize().items():
                    if '/' not in key:
                        continue
                    site_id, stat = key.rsplit('/', 1)
                    # a scalar for per-tensor sites, a channel vector for
                    # grouped conv inputs
                    agg.setdefault(site_id, {}).setdefault(stat, []).append(
                        v.double().cpu().numpy())

        frozen: dict[str, Any] = {}
        for site_id, stats in agg.items():
            # linear/classifier inputs always quantize on the full int8 grid
            # (QLinear), ':out' sites (downsample identity codes) likewise,
            # and conv0 (the in_ch == 3 stem) is the reference's automatic
            # 8-bit exception for int4 runs (i_q_m.py:336-338)
            bits = (8 if site_id.startswith(('linear', 'conv0_')) or site_id.endswith(':out')
                    else act_bits)
            qmax = 2.0 ** (bits - 1) - 1.0
            # every reduction is elementwise, so vector stats freeze to vectors
            absmax = np.maximum.reduce(stats['absmax'])
            if mode == 'max':
                clip = absmax
            elif mode == 'percentile':
                clip = np.maximum.reduce(stats['pq'])
            else:
                clip = np.minimum(ALPHA_LAPLACE[bits] * np.mean(stats['b'], axis=0), absmax)
            val = np.maximum(clip / qmax, 1e-8)
            frozen[site_id] = float(val) if np.ndim(val) == 0 else val.astype(np.float32)
        return frozen

    def freeze_qparams(self, stats, input_shape=None):
        """Per-site (delta, offset, qmax) from a stats artifact, as tensors on
        the model's device (engine/qparams.py).  ``input_shape`` is NHWC, as
        in the JAX package."""
        from .qparams import discover_sites, freeze_qparams
        if input_shape is None:
            s = self.meta.input_size
            input_shape = (1, s, s, 3)
        n, h, w, c = input_shape
        sites = discover_sites(self.model, (n, c, h, w))
        return freeze_qparams(self.policy, stats, sites, self.ignore_ids,
                              device=self.device)

    def make_collect(self, per_channel: bool | None = None,
                     batch_avg: bool = False,
                     err_bits: int | None = None) -> Callable:
        """f(params, x) -> (logits, stats_batch) for calibration.  ``err_bits``
        also collects per-prior quantization-error columns at that width."""
        if per_channel is None:
            per_channel = self.policy.pcq_act

        @torch.no_grad()
        def fwd(params, images):
            ctx = CollectContext(per_channel=per_channel, batch_avg=batch_avg,
                                 err_bits=err_bits)
            x = nhwc_to_nchw(images, self.device)
            logits = torch.func.functional_call(self.model, params, (x, ctx))
            return logits, ctx.finalize()

        return fwd


def s2d_stem_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Space-to-depth transform of a 7x7/2 pad-3 stem kernel [O, 3, 7, 7] to
    the equivalent stride-1 kernel [O, 12, 4, 4].

    Output row i of the original conv covers padded-image rows 2i..2i+6.
    After s2d by 2 (channel order: row phase, col phase, channel), s2d row
    i+j holds padded rows (2(i+j), 2(i+j)+1), so the window is s2d rows
    i..i+3 with tap [j, phase] = w8[2j+phase], w8 being the 7x7 kernel
    zero-padded to 8x8."""
    o, c = kernel.shape[:2]
    w8 = F.pad(kernel, (0, 1, 0, 1))                       # [O, C, 8, 8]
    return (w8.reshape(o, c, 4, 2, 4, 2)                   # o, c, j, ph, i, pw
            .permute(0, 3, 5, 1, 2, 4)                     # o, ph, pw, c, j, i
            .reshape(o, 4 * c, 4, 4))


def s2d_stem_input(x: torch.Tensor) -> torch.Tensor:
    """pad(x, 3) then space-to-depth by 2: [N, C, H, W] -> [N, 4C, (H+6)/2,
    (W+6)/2] (channel order row phase, col phase, channel, as
    ``s2d_stem_kernel``), in channels_last memory.  Needs H and W even.  For
    int8 codes the zero padding is exact (zero point 0)."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f's2d stem needs an even input size, got {h}x{w}')
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 3, 3, 3, 3))  # NHWC, H and W padded
    h, w = h + 6, w + 6
    return (xp.reshape(n, h // 2, 2, w // 2, 2, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4 * c)
            .permute(0, 3, 1, 2))
