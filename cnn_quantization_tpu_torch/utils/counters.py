"""The port's counters, in one store: the kernels' launches by route, the int8
epilogues' features, the bytes of floats the integer layers quantize on
entry, and the bytes the models' concatenations write.

Each counter is an integer under a constant name:

* ``'<kernel>.<route>'`` (and ``'fake_quant'``, ``'stream_copy'``,
  ``'quantize_codes.launches'``, kernels of one route) counts launches on the
  card only: off the card a wrapper runs its plain version.  A kernel's total
  is the sum of its routes (``by_kernel``);
* ``'int8_{gemm,conv}.{codes_out,residual_in}'`` counts the wrappers' calls
  whose epilogue emits codes or adds a residual, ``'*.float_in_bytes'`` the
  bytes of floating activations an integer conv or linear quantizes itself,
  and ``'concat.bytes'`` the bytes a model's channel concatenations write, on
  either device;
* ``'serving_graph.{captures,replays}'`` counts the frozen serving forwards
  captured into a CUDA graph and replayed from one (``engine/engine.py``).
  A replay runs no wrapper, so it adds the counts its capture moved: a
  replayed forward counts what an eager one would.

``add`` is a host add from shapes and flags: nothing reads the device.  A
reader takes a ``snapshot`` before and ``since`` after, as ``engine.forward``'s
span does for its counts.
"""

from __future__ import annotations

NAMES = ('fake_quant', 'int8_gemm.wgmma', 'int8_gemm.mma_sync', 'int8_conv.im2col_wgmma',
         'int8_conv.implicit_gemm', 'int8_conv.depthwise', 'int4_gemm.wgmma',
         'int4_gemm.mma_sync', 'int8_gemm.codes_out', 'int8_conv.codes_out',
         'int8_gemm.residual_in', 'int8_conv.residual_in', 'int8_gemm.float_in_bytes',
         'int8_conv.float_in_bytes', 'concat.bytes', 'quantize_codes.launches', 'stream_copy',
         'serving_graph.captures', 'serving_graph.replays')

# the kernel each launch counter belongs to, in the order ``by_kernel`` reports
KERNEL_OF = {'fake_quant': 'fake_quant',
             'int8_gemm.wgmma': 'int8_gemm', 'int8_gemm.mma_sync': 'int8_gemm',
             'int8_conv.im2col_wgmma': 'int8_conv', 'int8_conv.implicit_gemm': 'int8_conv',
             'int8_conv.depthwise': 'int8_conv',
             'int4_gemm.wgmma': 'int4_gemm', 'int4_gemm.mma_sync': 'int4_gemm',
             'stream_copy': 'stream_copy'}

_counts = dict.fromkeys(NAMES, 0)


def add(name: str, n: int = 1):
    """Adds ``n`` to the counter ``name`` (one of ``NAMES``)."""
    _counts[name] += n


def snapshot() -> dict:
    """Every counter as it stands."""
    return dict(_counts)


def restore(before: dict):
    """Sets every counter back to what ``snapshot()`` returned as ``before``."""
    _counts.update(before)


def since(before: dict) -> dict:
    """The counters that moved since ``snapshot()`` returned ``before``, by
    how much."""
    return {name: n - before[name] for name, n in _counts.items() if n != before[name]}


def by_kernel(counts: dict) -> dict:
    """The launches of each kernel in ``counts`` (a ``snapshot`` or a
    ``since``): its routes summed, 0 for a kernel with none."""
    out = dict.fromkeys(KERNEL_OF.values(), 0)
    for name, kernel in KERNEL_OF.items():
        out[kernel] += counts.get(name, 0)
    return out
