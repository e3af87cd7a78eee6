import types

from .fake_quant import (fake_quant_fused, fake_quant_fused_plain,
                         fake_quant_kernel_semantics_fused,
                         fake_quant_kernel_semantics_plain)
from . import int4_matmul as _int4, int_conv as _int_conv, int_matmul as _int_matmul

# the bytes the models' channel concatenations write (the Inception-v3 mixed
# blocks); here beside the kernels' counters, which the models import
CONCAT = types.SimpleNamespace(bytes=0)

# each kernel's launch counters by route, then the int8 epilogues' calls that
# emit codes or add a residual, the bytes of floats the integer convs and
# linears quantize on entry (on either device), the concatenations' bytes,
# and the float hand-off's codes kernel launches, as ``launch_counts`` reads
# them
_COUNTERS = (('fake_quant', fake_quant_fused, 'launches'),
             ('int8_gemm.wgmma', _int_matmul.int8_matmul_dequant, 'launches_wgmma'),
             ('int8_gemm.mma_sync', _int_matmul.int8_matmul_dequant, 'launches_mma_sync'),
             ('int8_conv.im2col_wgmma', _int_conv.int8_conv_dequant, 'launches_im2col_wgmma'),
             ('int8_conv.implicit_gemm', _int_conv.int8_conv_dequant, 'launches_implicit_gemm'),
             ('int8_conv.depthwise', _int_conv.int8_conv_dequant, 'launches_depthwise'),
             ('int4_gemm.wgmma', _int4.int4_matmul, 'launches_wgmma'),
             ('int4_gemm.mma_sync', _int4.int4_matmul, 'launches_mma_sync'),
             ('int8_gemm.codes_out', _int_matmul.FEATURE_CALLS, 'codes_out'),
             ('int8_conv.codes_out', _int_conv.FEATURE_CALLS, 'codes_out'),
             ('int8_gemm.residual_in', _int_matmul.FEATURE_CALLS, 'residual_in'),
             ('int8_conv.residual_in', _int_conv.FEATURE_CALLS, 'residual_in'),
             ('int8_gemm.float_in_bytes', _int_matmul.FEATURE_CALLS, 'float_in_bytes'),
             ('int8_conv.float_in_bytes', _int_conv.FEATURE_CALLS, 'float_in_bytes'),
             ('concat.bytes', CONCAT, 'bytes'),
             ('quantize_codes.launches', _int_matmul.quantize_sym_codes, 'launches'))


def launch_counts() -> list:
    """The kernels' counters, in ``_COUNTERS``' order."""
    return [getattr(fn, attr) for _, fn, attr in _COUNTERS]


def launches_since(before: list) -> dict:
    """{'<kernel>.<route>': launches, '<kernel>.<feature>': calls} made since
    ``launch_counts()`` read ``before``, the counters that moved alone."""
    return {key: n - b for (key, fn, attr), b in zip(_COUNTERS, before)
            if (n := getattr(fn, attr)) != b}
