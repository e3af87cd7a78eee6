from .policy import QuantPolicy, is_fused_relu_arch, parse_qtype_bits
from .context import (Site, TapContext, CollectContext, QuantizeContext,
                      ServingInt8Context)
from .engine import QuantEngine, ModelMeta
