from .fake_quant import (fake_quant_fused, fake_quant_fused_plain,
                         fake_quant_kernel_semantics_fused,
                         fake_quant_kernel_semantics_plain)
