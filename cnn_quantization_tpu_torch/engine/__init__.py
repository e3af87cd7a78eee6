from .policy import QuantPolicy, is_fused_relu_arch, parse_qtype_bits
from .context import Site, TapContext, CollectContext, QuantizeContext
from .engine import QuantEngine, ModelMeta
