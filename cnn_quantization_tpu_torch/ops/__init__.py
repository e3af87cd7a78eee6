from .quant_math import (affine_qparams, alpha_to_delta_offset, fake_quant,
                         minmax_delta_offset, qmax_for_bits, quantize_codes,
                         dequantize_codes)
from .quantizer import QuantConfig, quantize_activation, quantize_weight
from .bit_alloc import get_omega, get_bits_alloc, get_bits_alloc_fixed_target
from .bias_corr import weight_correction, activation_bias_correction
from .entropy import shannon_entropy, most_frequent_value_compression
from . import aciq, stats
