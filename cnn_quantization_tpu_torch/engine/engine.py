"""QuantEngine: weight quantization and quantized forward passes.

Port of ``cnn_quantization_tpu/engine/engine.py`` (simulation half; the
reference's ``QuantizationManagerInference``, i_q_m.py:286-393).  Parameters
are a ``state_dict`` (name -> tensor) in torchvision naming with OIHW conv and
[out, in] linear weights; a forward runs the model's module tree on them with
``torch.func.functional_call``, the counterpart of ``model.apply``.

The serving methods (``prepare_serving_params``, ``freeze_serving_scales``)
and the space-to-depth stem come with the true-int8 serving slice (ROADMAP
Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from ..ops import bias_corr
from ..ops.quantizer import quantize_weight
from ..utils.device import nhwc_to_nchw
from .context import CollectContext, QuantizeContext, TapContext
from .policy import QuantPolicy


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

    def make_forward(self, quantized: bool = True, qparams=None) -> Callable:
        """f(params, stats, images) -> (logits, aux).  ``images`` are NHWC, as
        the JAX package takes them; the model runs them as an NCHW
        channels_last view on its device.  ``stats`` is the calibration dict
        or None; ``qparams`` (from ``freeze_qparams``) enables the frozen path
        per site."""

        @torch.no_grad()
        def fwd(params, stats, images):
            if quantized and self.policy.qtype is not None:
                ctx = QuantizeContext(self.policy, stats=stats,
                                      ignore_ids=self.ignore_ids, qparams=qparams)
            else:
                ctx = TapContext()
            x = nhwc_to_nchw(images, self.device)
            logits = torch.func.functional_call(self.model, params, (x, ctx))
            return logits, ctx.finalize()

        return fwd

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
