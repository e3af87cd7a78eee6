"""Profiling and roofline accounting.

Port of ``cnn_quantization_tpu/utils/profiling.py``.  XLA's cost analysis and
its optimized-HLO traffic walk have no counterpart in eager PyTorch; in their
place ``count_work`` observes one forward and counts, from the shapes that
forward really saw,

  * operations: 2 x the multiply-accumulates of every conv and linear module
    that ran, whichever kernel carried it;
  * bytes: the operands and the output, once each, of every call of a kernel
    wrapper and of every PyTorch operator outside them that is not a view
    (each elementwise pass, pool, cast, float conv).

The count is of the work, not of an implementation: what runs inside a kernel
wrapper (the kernel on the card, its plain version on the CPU) is not looked
into, so the card and the CPU count the same.  ``cost_analysis(fn, *args)``,
the counterpart of the JAX function of that name, counts one call of any
function the same way: operations by ``torch.utils.flop_counter`` and from
the kernel wrappers' shapes, bytes as above.

``roofline_report`` holds a measured rate against the card's published peaks;
``per_op_profile`` is ``torch.profiler``'s device self-time by kernel name;
``device_ms`` times a call on the card with CUDA events; ``trace`` writes a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

# per-card peaks, dense (NVIDIA's H100 SXM data sheet: 700 W power limit)
PEAKS = {
    'h100': {'bf16_flops': 989e12, 'int8_ops': 1979e12, 'fp32_flops': 67e12,
             'hbm_gbps': 3.35e12},
    'cpu': {'bf16_flops': 1e12, 'int8_ops': 2e12, 'fp32_flops': 1e12, 'hbm_gbps': 50e9},
}


def device_peaks(device=None):
    """The peaks of the card ``device`` names (``None``: the current CUDA
    device if there is one), keyed by ``torch.cuda.get_device_name``; the
    ``'cpu'`` entry for the CPU.  A card the table does not know raises: a
    share of some other card's peak would be a wrong number."""
    dev = torch.device(device if device is not None
                       else ('cuda' if torch.cuda.is_available() else 'cpu'))
    if dev.type == 'cuda':
        kind = torch.cuda.get_device_name(dev).lower()
        for key, peaks in PEAKS.items():
            if key in kind:
                return peaks
        raise ValueError(f'no peak rates known for {kind!r}: add its data-sheet figures to '
                         'PEAKS')
    return PEAKS['cpu']


@dataclasses.dataclass
class RooflineReport:
    flops_per_call: float
    bytes_per_call: float   # counted: each kernel's and each pass's operands and output once
    calls_per_sec: float
    achieved_flops: float
    achieved_bw: float
    peak_flops: float
    peak_bw: float

    @property
    def compute_util(self):
        return self.achieved_flops / self.peak_flops

    @property
    def bandwidth_util(self):
        return self.achieved_bw / self.peak_bw

    @property
    def bound(self):
        return 'compute' if self.compute_util >= self.bandwidth_util else 'memory'

    @property
    def mem_roofline_mfu(self):
        """The compute utilization the memory roofline permits at this byte
        count: flops / (peak_flops * bytes / peak_bw).  A compute_util close
        to it means the path runs at the memory limit and only fewer bytes
        per call can raise it."""
        if self.bytes_per_call == 0:
            return float('inf')
        return (self.flops_per_call / self.bytes_per_call
                * self.peak_bw / self.peak_flops)

    def __str__(self):
        return (f'{self.flops_per_call / 1e9:.2f} GOP/call @ '
                f'{self.calls_per_sec:.1f} calls/s -> '
                f'{self.achieved_flops / 1e12:.1f} TOP/s '
                f'({self.compute_util:.1%} of peak), '
                f'{self.achieved_bw / 1e9:.0f} GB/s '
                f'({self.bandwidth_util:.1%} of the memory rate) [{self.bound}-bound]')


class WorkCounter(TorchDispatchMode):
    """Counts the bytes PyTorch operators move while it is active; kernel
    wrappers and module hooks add theirs through ``add_call``/``add_ops``."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.paused = 0

    @staticmethod
    def _nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def add_call(self, inputs, outputs):
        tensors = [t for t in tree_leaves((inputs, outputs)) if isinstance(t, torch.Tensor)]
        self.bytes += self._nbytes(tensors)

    def add_ops(self, ops):
        self.ops += ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        held = {t.untyped_storage().data_ptr() for t in ins if t.device.type != 'meta'}
        fresh = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                 and (t.device.type == 'meta' or t.untyped_storage().data_ptr() not in held)]
        # a view (an output in an input's storage) moves nothing; an in-place
        # operator reads its operands and writes one of them
        if fresh or func._schema.is_mutable:
            self.bytes += self._nbytes(ins) + self._nbytes(fresh)
        return out


def _kernel_wrappers():
    from ..ops.kernels import fake_quant, int4_matmul, int_conv, int_matmul
    return ((fake_quant, 'fake_quant_fused'), (fake_quant, 'fake_quant_kernel_semantics_fused'),
            (int_matmul, 'int8_matmul_dequant'), (int_conv, 'int8_conv_dequant'),
            (int4_matmul, 'int4_matmul'))


def _wrapper_ops(name, args, out) -> int:
    """2·M·N·K of one call of the kernel wrapper ``name``, from its shapes
    (the elementwise fake-quant wrappers: none)."""
    if name in ('int8_matmul_dequant', 'int4_matmul'):
        return 2 * args[0].shape[0] * args[1].shape[0] * args[1].shape[1]
    if name == 'int8_conv_dequant':
        return 2 * out.numel() * math.prod(args[1].shape[1:])
    return 0


@contextlib.contextmanager
def _observed(module, name, counter, ops=False):
    """While active, ``module.name`` counts its operands and output once (and
    with ``ops`` its 2·M·N·K) and hides what it runs inside from ``counter``
    and every other dispatch mode."""
    real = getattr(module, name)

    @functools.wraps(real)
    def call(*args, **kwargs):
        counter.paused += 1
        try:
            with _disable_current_modes():
                out = real(*args, **kwargs)
        finally:
            counter.paused -= 1
        if not counter.paused:
            counter.add_call((args, kwargs), out)
            if ops:
                counter.add_ops(_wrapper_ops(name, args, out))
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, real)


def count_work(model, fn):
    """Run ``fn()`` (one forward of ``model``) and return ``(ops, bytes)``
    as the module docstring defines them."""
    from ..models.layers import QConv, QLinear
    counter = WorkCounter()

    def macs(module, _args, output):
        y = output.codes if hasattr(output, 'codes') else output
        if isinstance(module, QConv):
            positions = y.numel() // y.shape[1]        # N * Ho * Wo (a packed output halves C)
            per_out = math.prod(module.weight.shape[1:])
            counter.add_ops(2 * positions * module.features * per_out)
        else:
            counter.add_ops(2 * y.numel() * module.weight.shape[1])

    hooks = [m.register_forward_hook(macs) for m in model.modules()
             if isinstance(m, (QConv, QLinear))]
    try:
        with contextlib.ExitStack() as stack:
            for module, name in _kernel_wrappers():
                stack.enter_context(_observed(module, name, counter))
            with counter:
                fn()
    finally:
        for h in hooks:
            h.remove()
    return counter.ops, counter.bytes


def cost_analysis(fn, *args) -> dict[str, float]:
    """{'flops', 'bytes accessed'} of one call ``fn(*args)``, which runs: the
    operations ``torch.utils.flop_counter.FlopCounterMode`` counts (2 x the
    multiply-accumulates of each conv and matmul operator) plus 2·M·N·K of
    each kernel-wrapper call from its shapes, and the bytes ``count_work``
    counts.  On a model's forward the operations equal ``count_work``'s."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = WorkCounter()
    with contextlib.ExitStack() as stack:
        for module, name in _kernel_wrappers():
            stack.enter_context(_observed(module, name, counter, ops=True))
        with FlopCounterMode(display=False) as flops, counter:
            fn(*args)
    return {'flops': float(flops.get_total_flops() + counter.ops),
            'bytes accessed': float(counter.bytes)}


def roofline_report(model, fn, calls_per_sec: float, *, int8: bool = False, device=None):
    """Roofline of one forward ``fn()`` of ``model`` run ``calls_per_sec``
    times a second: operations and bytes from ``count_work``, peaks from
    ``device_peaks``.  A share of a peak above 1 cannot be: it raises, since
    then the timing or the count is at fault."""
    ops, nbytes = count_work(model, fn)
    peaks = device_peaks(device)
    rep = RooflineReport(
        flops_per_call=float(ops), bytes_per_call=float(nbytes), calls_per_sec=calls_per_sec,
        achieved_flops=ops * calls_per_sec, achieved_bw=nbytes * calls_per_sec,
        peak_flops=peaks['int8_ops'] if int8 else peaks['bf16_flops'],
        peak_bw=peaks['hbm_gbps'])
    if rep.compute_util > 1.0 or rep.bandwidth_util > 1.0:
        raise ValueError(f'a share of a peak above 1 ({rep}): the step time or the work '
                         'count is at fault')
    return rep


def device_ms(fn, iters: int = 30, warmup: int = 3, head_start: bool = True) -> float:
    """Mean time of ``fn()`` on the card, by CUDA events around ``iters`` calls.
    The device first spins for some 25 ms, so the host has queued calls before
    the first one starts: for a call whose launches the queue can hold, the
    events then bracket device work alone.  Without ``head_start`` a call
    shorter than the host's time to launch it reads as that launch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if head_start:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_by_kernel(fn):
    """(host wall ms, {device record: microseconds}) of one call of ``fn``
    under torch.profiler: kernels and copies only; a host op's entry repeats
    the time of the kernels it launched, and 'Activity Buffer Request' is
    CUPTI's bookkeeping record, not device work."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key == 'Activity Buffer Request':
            continue
        device_us[ev.key] = device_us.get(ev.key, 0) + ev.self_device_time_total
    return wall_ms, device_us


# device records by kernel class: the port's kernels by the loader, epilogue
# or kernel name in their names (the TMA + wgmma kernel of all three integer
# kernels is one template: its A loader or epilogue names the kernel; the
# first class that matches wins), PyTorch's elementwise passes, copies
KERNEL_CLASSES = (('int4_gemm', ('Int4A', 'Int4WgEpilogue')), ('int8_gemm', ('DenseA',)),
                  ('int8_conv', ('ConvA', 'Im2colA', 'int8_depthwise_kernel')),
                  ('fake_quant', ('fake_quant_kernel',)), ('stream_copy', ('stream_copy_kernel',)),
                  ('elementwise', ('elementwise_kernel',)), ('memcpy', ('Memcpy',)))


def kernel_class(name: str) -> str:
    """The ``KERNEL_CLASSES`` class of the device record ``name``, else
    ``'other'``."""
    return next((c for c, needles in KERNEL_CLASSES if any(s in name for s in needles)), 'other')


def device_ms_by_class(device_us) -> dict:
    """``device_time_by_kernel``'s records summed by ``KERNEL_CLASSES`` (ms),
    what matches none under ``'other'``."""
    out = {name: 0.0 for name, _ in KERNEL_CLASSES}
    out['other'] = 0.0
    for key, us in device_us.items():
        out[kernel_class(key)] += us / 1e3
    return out


def per_op_profile(fn, *, top_n: int = 12, warmup: int = 2):
    """Per-kernel device profile of one warm call of ``fn``: host wall time,
    device busy time, the device's idle share of the wall time, and the
    top-``top_n`` device records by self-time.  Without a card there is no
    device trace: returns ``None``, which callers treat as "no profile"."""
    if not torch.cuda.is_available():
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    wall_ms, device_us = device_time_by_kernel(fn)
    busy_ms = sum(device_us.values()) / 1e3
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:top_n]
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'device_idle_share': max(0.0, 1.0 - busy_ms / wall_ms),
            'device_records': len(device_us), 'by_class_ms': device_ms_by_class(device_us),
            'top': [{'op': k[:80], 'self_us': round(us, 1),
                     'pct': round(100.0 * us / max(busy_ms * 1e3, 1e-9), 2)}
                    for k, us in top]}


@contextlib.contextmanager
def trace(path: str):
    """torch.profiler trace of the enclosed block, written to ``path`` as a
    Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
