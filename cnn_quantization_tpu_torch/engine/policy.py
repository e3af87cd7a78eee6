"""Declarative quantization policy: per-tag quantizer configs.

Port of ``cnn_quantization_tpu/engine/policy.py``, copied as it is.  It
replaces the reference's imperative per-tag quantizer mutation
(reference: pytorch_quantizer/quantization/inference/
inference_quantization_manager.py:407-476, ``__fill_quantizers__``) with a
pure function QuantPolicy -> {tag: QuantConfig}.

Tag table (see SURVEY.md §2 "Quantization policy"):
  activation            conv/BN outputs           — full user config
  activation_linear     linear outputs            — user config, never per-channel
  activation_classifier final 1000-way outputs    — int8, no clip, stats kind max
  activation_pooling    pool outputs              — int8, no clip
  weight                conv/linear weights       — qweight bits, pcq_w, no clip
  weight_classifier     classifier weights        — int8, pcq_w, stats kind max
  bias                  —                         — never quantized
  ignored               8-bit exception list      — int8, no clip, per-tensor stats
"""

from __future__ import annotations

import dataclasses

from ..ops.quantizer import QuantConfig

# Archs whose convs all feed ReLUs ("fused relu"): activations treated as
# positive-only (inference_quantization_manager.py:492).
FUSED_RELU_ARCHS = ('alexnet', 'vgg16', 'vgg16_bn', 'inception_v3')


def is_fused_relu_arch(arch: str | None) -> bool:
    return arch is not None and (arch in FUSED_RELU_ARCHS or 'squeezenet' in arch)


def parse_qtype_bits(qtype: str) -> int:
    """'int4' -> 4; bare 'int' -> 32 (int_quantizer.py:626-632)."""
    suffix = qtype[len('int'):]
    return int(suffix) if suffix else 32


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """User-level knobs — the CLI flag surface of inference_sim.py:73-111."""
    qtype: str | None = None          # activation quantizer, e.g. 'int4'
    qweight: str = 'int8'             # weight quantizer, e.g. 'int4' or 'f32'
    clipping: str = 'no'              # no | laplace | gaus | <p>std | mix
    stats_kind: str = 'mean'
    kld: bool = False
    pcq_weights: bool = False
    pcq_act: bool = False
    bit_alloc_act: bool = False
    bit_alloc_weight: bool = False
    bit_alloc_rmode: str = 'round'
    bit_alloc_prior: str = 'gaus'
    bit_alloc_target_act: float | None = None
    bit_alloc_target_weight: float | None = None
    bias_corr_act: bool = False
    bias_corr_weight: bool = False
    var_corr_weight: bool = False
    measure_entropy: bool = False
    mtd_quant: bool = False
    stochastic: bool = False      # stochastic rounding on activation tags
    # fp32 pre-quantization clippers (reference --rho_act/--rho_weight,
    # inference_sim.py:84-85; constructed but never invoked there,
    # clipping_manager.py — live here: statistical clip on activations,
    # ratio clip on weights)
    rho_act: float | None = None
    rho_weight: float | None = None
    arch: str | None = None

    def base_config(self, num_bits: int) -> QuantConfig:
        return QuantConfig(
            num_bits=num_bits,
            clipping=self.clipping,
            stats_kind=self.stats_kind,
            kld=self.kld,
            pcq_w=self.pcq_weights,
            pcq_a=self.pcq_act,
            bit_alloc_act=self.bit_alloc_act,
            bit_alloc_weight=self.bit_alloc_weight,
            bit_alloc_round=self.bit_alloc_rmode == 'round',
            bit_alloc_prior=self.bit_alloc_prior,
            bit_alloc_target_act=self.bit_alloc_target_act,
            bit_alloc_target_weight=self.bit_alloc_target_weight,
            bcorr_act=self.bias_corr_act,
            bcorr_weight=self.bias_corr_weight,
            vcorr_weight=self.var_corr_weight,
            measure_entropy=self.measure_entropy,
            mtd_quant=self.mtd_quant,
            stochastic=self.stochastic,
            force_positive=is_fused_relu_arch(self.arch),
            stats_per_channel=self.pcq_act,
        )

    def tag_configs(self) -> dict[str, QuantConfig | None]:
        """The per-tag table.  None means "do not quantize" (DummyQuantizer)."""
        if self.qtype is None:
            return {}
        act_bits = parse_qtype_bits(self.qtype)
        base = self.base_config

        activation = dataclasses.replace(base(act_bits), pcq_w=False)
        activation_linear = dataclasses.replace(
            base(act_bits), pcq_w=False, pcq_a=False, stats_per_channel=False)
        # classifier: int8, no clipping/kld/pcq, per-tensor stats kind max
        activation_classifier = dataclasses.replace(
            base(8), clipping='no', kld=False, pcq_w=False, pcq_a=False,
            stats_per_channel=False, stats_kind='max', measure_entropy=False,
            force_positive=False, mtd_quant=False)
        activation_pooling = dataclasses.replace(
            base(8), clipping='no', kld=False, pcq_w=False, pcq_a=False,
            stats_per_channel=False, measure_entropy=False,
            force_positive=False, mtd_quant=False)
        ignored = dataclasses.replace(
            base(8), clipping='no', kld=False, pcq_w=False, pcq_a=False,
            stats_per_channel=False, force_positive=False, mtd_quant=False)

        # weight quantization is a one-shot deterministic pass
        # (quantize_model runs once, i_q_m.py:352-393) — never stochastic
        if self.qweight == 'f32':
            weight = None
        else:
            weight = dataclasses.replace(
                base(parse_qtype_bits(self.qweight)), pcq_a=False, clipping='no',
                kld=False, stats_kind='max', force_positive=False,
                stochastic=False)
        weight_classifier = dataclasses.replace(
            base(8), pcq_a=False, clipping='no', kld=False, stats_kind='max',
            measure_entropy=False, force_positive=False, mtd_quant=False,
            stochastic=False)

        # The reference's AvgPool2dWithId passes its tag POSITIONALLY as the
        # ``id`` argument (inference_quantization_manager.py:95-99), so every
        # avgpool output is quantized by the *default* int8 quantizer — raw
        # user params (clipping/pcq_w/pcq_a/mtd all live), force_positive
        # False (int_quantizer.py:90) — never by 'activation_pooling'.  The
        # published numbers include this quirk; mirrored here and verified
        # differentially in tests/test_full_model_parity.py.
        default = dataclasses.replace(base(8), force_positive=False,
                                      stochastic=False)

        return {
            'activation': activation,
            'activation_linear': activation_linear,
            'activation_classifier': activation_classifier,
            'activation_pooling': activation_pooling,
            'default': default,
            'weight': weight,
            'weight_classifier': weight_classifier,
            'bias': None,
            'ignored': ignored,
        }

    def default_ignore_ids(self) -> tuple[str, ...]:
        """int4 runs keep the first conv activation at 8 bits
        (inference_quantization_manager.py:334-340)."""
        if self.qtype == 'int4':
            return ('conv0_activation',)
        return ()
