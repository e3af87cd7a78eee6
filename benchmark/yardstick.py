"""The benchmark's fixed measures: the card's published peaks, the classes of
device kernels by name, and the work a forward needs, counted from the
model's shapes whatever implements it.

Frozen copies of the measured program's ``utils/profiling.py`` arithmetic:
``PEAKS`` is its H100 entry (NVIDIA's H100 SXM data sheet, dense rates, at the
700 W power limit) and ``KERNEL_CLASSES`` its kernel classes.  The operation
count is its ``count_work``'s (2 x the multiply-accumulates of every conv and
linear).  The bytes are not the program's: they count what the arithmetic
needs, so a kernel that moves fewer bytes is measured against the same bound.
"""

from __future__ import annotations

import functools
import math

PEAKS = {'fp32_flops': 67e12, 'int8_ops': 1979e12, 'hbm_bytes_per_s': 3.35e12}

# device kernels by class: the first class one of whose needles the name
# holds; the rest are 'other'
KERNEL_CLASSES = (('int4_gemm', ('Int4A', 'Int4WgEpilogue')), ('int8_gemm', ('DenseA',)),
                  ('int8_conv', ('ConvA', 'Im2colA', 'int8_depthwise_kernel')),
                  ('fake_quant', ('fake_quant_kernel',)), ('stream_copy', ('stream_copy_kernel',)),
                  ('elementwise', ('elementwise_kernel',)), ('memcpy', ('Memcpy',)))
# device records that are no device work
NOT_WORK = ('Activity Buffer Request',)


def kernel_class(name: str) -> str:
    return next((c for c, needles in KERNEL_CLASSES if any(s in name for s in needles)),
                'other')


@functools.lru_cache(maxsize=None)
def work(arch: str, input_size: int, batch: int) -> dict:
    """The work of one forward of a batch of ``batch`` images:

    * ``ops``: 2 x the multiply-accumulates of every conv and linear;
    * ``int8_bound_s``: the least time of the integer convs and linears of
      true-int8 serving (every conv but the three-channel stem, and the
      classifier): for each, the larger of 2 x MACs at the int8 peak and its
      bytes at the memory rate; the bytes are its int8 input codes, its int8
      weights and its output as the next layer needs it, int8 codes, or
      float32 logits for the classifier;
    * ``fake_quant_bound_s``: the least time of the simulation's fake-quant:
      each quantization site's tensor read and written once in float32, at
      the memory rate.
    """
    from .reference import recipes
    ops = recipes._shapes(arch, input_size, batch)
    total_ops, int8_s = 0, 0.0
    for name, x_shape, w_shape, y_shape, in_ch in ops.layers:
        positions = math.prod(y_shape) // y_shape[1] if len(y_shape) == 4 else y_shape[0]
        n_ops = 2 * positions * y_shape[1] * math.prod(w_shape[1:])
        total_ops += n_ops
        if in_ch == 3:
            continue
        out_bytes = math.prod(y_shape) * (4 if len(y_shape) == 2 else 1)
        nbytes = math.prod(x_shape) + math.prod(w_shape) + out_bytes
        int8_s += max(n_ops / PEAKS['int8_ops'], nbytes / PEAKS['hbm_bytes_per_s'])
    fq_bytes = sum(8 * math.prod(s) for s in ops.site_shapes.values())
    return {'ops': total_ops, 'int8_bound_s': int8_s,
            'fake_quant_bound_s': fq_bytes / PEAKS['hbm_bytes_per_s']}
