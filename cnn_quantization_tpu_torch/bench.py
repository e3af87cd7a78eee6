"""Benchmark: ResNet-50 quantized-inference throughput on one card.

    python3 -m cnn_quantization_tpu_torch.bench        (BENCH_BATCH=128 by default)

Port of the repository's ``bench.py``.  Primary metric: true-int8 serving
(per-channel int8 weights, frozen activation scales, the hand-written int8
GEMM and conv kernels).  ``vs_baseline`` is the ratio against the unquantized
bf16 forward on the same card.  Secondary rows:

  * the W4A4 fake-quant simulation (the reference's headline configuration,
    frozen qparams),
  * W4A4 *serving* with frozen scales, in the plain int8-resident form and the
    packed form (int4 GEMMs, block boundaries crossing device memory at 4
    bits),
  * a serving batch sweep and the run-to-run spread of the primary metric,
  * MobileNet-v2 serving (depthwise convs, per-channel activation scales),
  * an on-device smoke of the stochastic-rounding mode of the fake-quant
    kernel, the int8 tensor-core rate on a large product, and the streaming
    memory rate (a chain of dependent passes of the stream-copy kernel).

The model is built with bfloat16 activations; weights are seeded random and the
images synthetic, made on the device before any clock starts.

Timing: eager PyTorch neither hoists a forward out of a loop nor batches
dispatches, so a step's time is CUDA events around a few warm forwards queued
behind a short device spin; the host's wall time for the same forwards and the
device's idle share (1 - profiled device busy time / wall time) stand beside
it, since a path whose kernels are shorter than their launches is paced by the
host.  The serving rows replay a CUDA graph of the forward after its first
call (``QuantEngine.make_forward``).  Roofline fields come from counted work
(``utils/profiling.count_work``): 2 x MACs of every conv and linear, and every
kernel's and elementwise pass's operands and output once, counted on the
forward run module by module (its ``eager``), whose modules a replay does not
run.

Each section prints one JSON line as it ends; the LAST line is the short
headline object ``{"metric", "value", "unit", "vs_baseline", ...}``.  A section
that fails ends the run with a non-zero exit code and its name on stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from .calib.calibrator import collect_statistics
from .engine import QuantEngine, QuantPolicy
from .models import build_model
from .models.layers import (PackedQTensor, QAvgPool, QBatchNorm, QConv, QLinear, QMaxPool,
                            QTensor)
from .ops.kernels import fake_quant as fq
from .ops.kernels import int_matmul as im
from .ops.kernels import stream_copy as sc
from .utils import counters
from .utils.device import card_name_and_power, resolve_device
from .utils.profiling import device_ms, device_peaks, per_op_profile, roofline_report

METRIC = 'resnet50_int8_serving_images_per_sec_per_chip'
HEADLINE = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                bias_corr_weight=True)
WIDE = 1 << 21   # elements from which a float tensor between modules counts as wide


class BenchFailure(Exception):
    """A section of the bench failed; ``args[0]`` names it."""


def _emit(section, **fields):
    print(json.dumps({'section': section, **fields}), flush=True)


def _images(batch, size, device, seed=0):
    """NHWC float32 images on ``device``, made before any clock starts."""
    return torch.from_numpy(np.random.RandomState(seed).rand(batch, size, size, 3)
                            .astype(np.float32)).to(device)


def _step_seconds(fn, device, iters=5, warmup=2):
    """Seconds per warm call of ``fn`` by the device's clock: CUDA events
    behind a device spin on the card; on the CPU, which only a caller that
    asks for it gets, the host clock (the one branch the CPU needs)."""
    if device.type == 'cuda':
        return device_ms(fn, iters=iters, warmup=warmup) / 1e3
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _timed(fn, device, iters=5):
    """(seconds per call by the device's clock, seconds per call by the
    host's) of warm calls of ``fn``: the second is the host clock around the
    same number of calls, ending in a synchronise."""
    step = _step_seconds(fn, device, iters)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if device.type == 'cuda':
        torch.cuda.synchronize()
    return step, (time.perf_counter() - t0) / iters


def _forward_row(fwd, params, images, device):
    """One forward kind: step and wall time, and on the card the profiled
    device busy time by kernel class with the idle share of the wall time."""
    def call():
        return fwd(params, None, images)
    step, wall = _timed(call, device)
    row = {'step_ms': step * 1e3, 'wall_ms': wall * 1e3,
           'images_per_sec': images.shape[0] / step}
    prof = per_op_profile(call)
    if prof is not None:
        row.update(device_busy_ms=prof['device_busy_ms'],
                   device_idle_share=max(0.0, 1.0 - prof['device_busy_ms'] / (wall * 1e3)),
                   by_class_ms=prof['by_class_ms'], top=prof['top'])
    return row


def module_inputs(model, call):
    """What one forward (``call()``) hands each conv, linear, BN and pool
    module, in call order: ``[(module, kind, dtype, elements)]`` with ``kind``
    'codes' (a ``QTensor``), 'packed' (a ``PackedQTensor``) or 'float'."""
    seen = []

    def pre(module, args):
        x = args[0]
        if isinstance(x, PackedQTensor):
            seen.append((module, 'packed', x.codes.dtype, x.codes.numel()))
        elif isinstance(x, QTensor):
            seen.append((module, 'codes', x.codes.dtype, x.codes.numel()))
        else:
            seen.append((module, 'float' if x.is_floating_point() else 'codes', x.dtype,
                         x.numel()))

    kinds = (QConv, QLinear, QBatchNorm, QMaxPool, QAvgPool)
    hooks = [m.register_forward_pre_hook(pre) for m in model.modules() if isinstance(m, kinds)]
    try:
        call()
    finally:
        for h in hooks:
            h.remove()
    return seen


def wide_float_handoffs(model, call, image_elems):
    """Float tensors of at least ``WIDE`` elements that one forward hands to a
    conv, linear, BN or pool module (codes, int8 or packed, are what a
    resident path hands over instead).  The image itself, cast to the model's
    type for the float stem, is input-pipeline work and is not counted."""
    return sum(1 for _, kind, _, n in module_inputs(model, call)
               if kind == 'float' and n >= WIDE and n != image_elems)


def bench(arch='resnet50', batch=128, dtype='bfloat16', size=224, device=None):
    """The five forwards of ``arch`` at ``batch`` x ``size`` x ``size``:
    W4A4 simulation (frozen qparams from 8 images), unquantized ``dtype``,
    W8A8 serving (scales frozen from 16 images), W4A4 serving plain and
    packed.  Returns the rows, the two roofline reports and what the later
    sections reuse."""
    dev = resolve_device(device)
    model, meta = build_model(arch, dtype=dtype, device=dev)
    params = dict(model.state_dict())
    images = _images(batch, size, dev)
    labels = np.zeros(batch, np.int32)
    rows = {}

    # ---- W4A4 fake-quant simulation (reference headline, frozen qparams)
    eng = QuantEngine(model, QuantPolicy(arch=arch, **HEADLINE), meta)
    pq = eng.quantize_params(params)
    stats = collect_statistics(eng.make_collect(), params, [(images[:8], labels[:8])])
    qp = eng.freeze_qparams(stats, input_shape=(batch, size, size, 3))
    rows['w4a4_sim'] = _forward_row(eng.make_forward(quantized=True, qparams=qp), pq, images, dev)

    # ---- unquantized baseline in the model's dtype
    rows['bf16'] = _forward_row(eng.make_forward(quantized=False), params, images, dev)

    # ---- true-int8 serving (primary)
    eng8 = QuantEngine(model, QuantPolicy(qtype='int8', qweight='int8', arch=arch), meta)
    sp8 = eng8.prepare_serving_params(eng8.quantize_params(params))
    cal16 = [(images[:16], labels[:16])]
    scales = eng8.freeze_serving_scales(sp8, cal16)
    fwd_s = eng8.make_forward(quantized='serving_int8', act_scales=scales)
    rows['serving'] = _forward_row(fwd_s, sp8, images, dev)

    # ---- W4A4 serving: plain int8-resident and int4-packed boundaries
    eng4 = QuantEngine(model, QuantPolicy(qtype='int4', qweight='int4', arch=arch), meta)
    sp4 = eng4.prepare_serving_params(eng4.quantize_params(params))
    scales4 = eng4.freeze_serving_scales(sp4, cal16, packed=True)
    rows['w4a4_serving'] = _forward_row(
        eng4.make_forward(quantized='serving_int8', act_scales=scales4), sp4, images, dev)
    fwd_w4p = eng4.make_forward(quantized='serving_int8', act_scales=scales4, packed=True)
    rows['w4a4_packed'] = _forward_row(fwd_w4p, sp4, images, dev)

    # ---- roofline from counted work, and the wide float hand-offs: both
    # watch the forward's modules, which a replayed graph does not run
    rep = roofline_report(model, lambda: fwd_s.eager(sp8, None, images),
                          calls_per_sec=rows['serving']['images_per_sec'] / batch, int8=True,
                          device=dev)
    rep4 = roofline_report(model, lambda: fwd_w4p.eager(sp4, None, images),
                           calls_per_sec=rows['w4a4_packed']['images_per_sec'] / batch,
                           int8=True, device=dev)
    offenders = wide_float_handoffs(model, lambda: fwd_s.eager(sp8, None, images),
                                    images.numel())
    return {'rows': rows, 'rep': rep, 'rep4': rep4, 'int8_resident_offenders': offenders,
            'engines': (eng8, sp8, scales), 'size': size, 'device': dev}


def _serving_spread(res, batch, reps=3):
    """Re-time the primary serving path ``reps`` times (fresh timing loops)
    and report min/median/max; the primary measurement is part of the band,
    so ``value`` always lies inside its own spread."""
    eng8, sp8, scales = res['engines']
    fwd_s = eng8.make_forward(quantized='serving_int8', act_scales=scales)
    images = _images(batch, res['size'], res['device'])
    ips = sorted([batch / _timed(lambda: fwd_s(sp8, None, images), res['device'])[0]
                  for _ in range(reps)] + [res['rows']['serving']['images_per_sec']])
    return {'min': round(ips[0], 1), 'median': round(ips[len(ips) // 2], 1),
            'max': round(ips[-1], 1)}


def _batch_sweep(res, batches):
    """Re-time the primary serving path at other batch sizes (same frozen
    scales: calibration does not depend on the batch)."""
    eng8, sp8, scales = res['engines']
    fwd_s = eng8.make_forward(quantized='serving_int8', act_scales=scales)
    sweep, detail = {}, {}
    for b in batches:
        images = _images(b, res['size'], res['device'])
        step, wall = _timed(lambda: fwd_s(sp8, None, images), res['device'])
        sweep[str(b)] = round(b / step, 2)
        detail[str(b)] = {'step_ms': step * 1e3, 'wall_ms': wall * 1e3}
    return sweep, detail


def _mobilenet_serving(batch, size, device):
    """True-int8 serving throughput of MobileNet-v2 (depthwise trunk,
    per-channel frozen activation scales at the depthwise sites)."""
    model, meta = build_model('mobilenet_v2', device=device)
    eng = QuantEngine(model, QuantPolicy(qtype='int8', qweight='int8', arch='mobilenet_v2'),
                      meta)
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))
    images = _images(batch, size, device, seed=1)
    scales = eng.freeze_serving_scales(sp, [(images[:16], np.zeros(16, np.int32))])
    n_vec = sum(1 for v in scales.values() if np.ndim(v) == 1)
    fwd = eng.make_forward(quantized='serving_int8', act_scales=scales)
    row = _forward_row(fwd, sp, images, device)
    # the depthwise convs' least time: int8 codes and weights read once, the
    # float32 output written once, at the card's memory rate (the conv kernel
    # runs nothing else on this model, so its class time is theirs)
    moved = []
    hooks = [m.register_forward_hook(lambda mod, args, out: moved.append(
        args[0].numel() + mod.weight.numel() + out.numel() * out.element_size()))
        for m in model.modules() if isinstance(m, QConv) and m.groups > 1]
    try:
        fwd.eager(sp, None, images)
    finally:
        for h in hooks:
            h.remove()
    row.update(depthwise_convs=len(moved),
               depthwise_bound_ms=sum(moved) / device_peaks(device)['hbm_gbps'] * 1e3)
    return {'mobilenet_serving_images_per_sec': round(row['images_per_sec'], 2),
            'mobilenet_per_channel_act_sites': n_vec}, row


PROBE_GEMM = (4096, 16384, 4096)   # the rate probe's product: [M, K] x [K, N]
PROBE_ROWS = 128 * 56 * 56         # the memory-rate probe's int8 tensor: [rows, 256]


def _mxu_rate_probe(device, shape=PROBE_GEMM):
    """The int8 tensor-core rate on one large product, [4096, 16384] x
    [16384, 4096]: ``torch._int_mm`` stands for the reference's plain
    ``lax.dot_general`` (``int8_dot_tops``), and the port's own int8 GEMM
    kernel is timed at the same shape beside it."""
    m, k, n = shape
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8)).to(device)
    bt = torch.from_numpy(rs.randint(-127, 128, (n, k)).astype(np.int8)).to(device)
    b = bt.t()   # K contiguous in both operands, as the serving path holds them
    alpha = torch.full((n,), 1e-3, device=device)
    t_dot = _step_seconds(lambda: torch._int_mm(a, b), device, iters=10, warmup=3)
    t_own = _step_seconds(lambda: im.int8_matmul_dequant(a, b, alpha), device, iters=10,
                          warmup=3)
    ops, peak = 2 * m * n * k, device_peaks(device)['int8_ops']
    return {'int8_dot_tops': round(ops / t_dot / 1e12, 1),
            'int8_dot_mfu': round(ops / t_dot / peak, 4),
            'int8_gemm_kernel_tops': round(ops / t_own / 1e12, 1),
            'int8_gemm_kernel_mfu': round(ops / t_own / peak, 4)}


def _dma_probe(device, rows=PROBE_ROWS, steps=36):
    """The streaming memory rate the card reaches in practice: a chain of
    ``steps`` dependent passes of the stream-copy kernel over a
    serving-boundary-sized int8 tensor ([128*56*56, 256], read and written
    once per step).  Each step's scalar is derived on the device from every
    partial sum of the step before, so steps neither overlap nor fold, and
    the host never waits inside the chain.  A reading outside (0, the card's
    peak rate) is not hidden: the median of the sane ones is reported, or the
    insane one with ``dma_probe_sane: false``."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(-127, 128, (rows, 256)).astype(np.int8)).to(device)
    nbytes = 2 * x.numel()   # read + write per step

    def chain():
        c, s = x, torch.zeros(1, dtype=torch.int32, device=device)
        for _ in range(steps):
            c, psums = sc.stream_copy(c, s)
            s = sc.stream_copy_carry(psums)
        return c

    def one_reading():
        return nbytes * steps / _step_seconds(chain, device, iters=1, warmup=1) / 1e9

    peak = device_peaks(device)['hbm_gbps'] / 1e9
    readings = [one_reading() for _ in range(5)]
    sane = [g for g in readings if 0 < g < peak]
    if not sane:
        return {'dma_copy_gbps': round(readings[0], 1), 'dma_probe_sane': False}
    return {'dma_copy_gbps': round(float(np.median(sane)), 1), 'dma_probe_sane': True}


def _stochastic_smoke(device):
    """Run the stochastic-rounding mode of the fake-quant kernel and check
    that the rounding is unbiased and depends on the seed.  Theory for uniform
    x with U[-0.5, 0.5) noise: P(noisy != deterministic) = 1/4, P(two
    independent noisy roundings differ) = 1/3."""
    rs = np.random.RandomState(0)
    n = 512 * 1024
    delta, qmax = 4.0, 15.0
    x = torch.from_numpy(rs.rand(n // 256, 256).astype(np.float32) * delta).to(device)
    a = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=7)
    b = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=8)
    det = fq.fake_quant_fused(x, delta, 0.0, qmax)
    step = delta / qmax
    bias = float((a - x).mean())
    se = step / np.sqrt(12.0 * n)
    ok = (abs(bias) < 6 * se) and 0.25 < float((a != b).float().mean()) < 0.42 \
        and 0.17 < float((a != det).float().mean()) < 0.33
    return {'cuda_stochastic_ok': bool(ok), 'stochastic_mean_bias': round(bias, 7),
            'stochastic_bias_tol_6se': round(6 * se, 7)}


def run(*, arch='resnet50', batch=128, size=224, sweep=(64, 256), device=None,
        probe_gemm=PROBE_GEMM, probe_rows=PROBE_ROWS):
    """Every section in turn.  Returns (headline, launches): the headline
    dict, and for each section the kernel launches it made on the card.
    ``probe_gemm`` and ``probe_rows`` size the two rate probes."""
    dev = resolve_device(device)
    card = card_name_and_power() if dev.type == 'cuda' else 'cpu'
    print(card, flush=True)
    launches = {}

    def _section(name, fn, *args, **kwargs):
        before = counters.snapshot()
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            raise BenchFailure(name) from e
        launches[name] = counters.by_kernel(counters.since(before))
        return out

    r = _section('bench', bench, arch=arch, batch=batch, size=size, device=dev)
    rows, rep, rep4 = r['rows'], r['rep'], r['rep4']
    _emit('forwards', card=card, arch=arch, batch=batch, input_size=size, dtype='bfloat16',
          **{name: {k: v for k, v in row.items() if k != 'top'} for name, row in rows.items()})
    _emit('per_op_top', **{name: rows[name].get('top') for name in ('serving', 'w4a4_packed')})
    sweep_ips, sweep_detail = _section('batch_sweep', _batch_sweep, r, sweep)
    sweep_ips[str(batch)] = round(rows['serving']['images_per_sec'], 2)
    _emit('batch_sweep', images_per_sec=sweep_ips, detail=sweep_detail)
    spread = _section('serving_spread', _serving_spread, r, batch)
    mob, mob_row = _section('mobilenet_serving', _mobilenet_serving, batch, size, dev)
    _emit('mobilenet_serving', card=card, **mob, **mob_row)
    smoke = _section('stochastic_smoke', _stochastic_smoke, dev)
    smoke.update(_section('mxu_rate_probe', _mxu_rate_probe, dev, probe_gemm))
    smoke.update(_section('dma_probe', _dma_probe, dev, probe_rows))
    _emit('probes', card=card, **smoke)
    _emit('kernel_launches', **launches)
    if smoke['dma_probe_sane']:
        smoke['mfu_ceiling_mem_practical'] = round(
            rep.mem_roofline_mfu * smoke['dma_copy_gbps'] * 1e9 / rep.peak_bw, 4)
    ips = {name: row['images_per_sec'] for name, row in rows.items()}
    return {
        'metric': METRIC.replace('resnet50', arch),
        'value': round(ips['serving'], 2),
        'unit': 'images/sec',
        'vs_baseline': round(ips['serving'] / ips['bf16'], 4),
        'w4a4_sim_images_per_sec': round(ips['w4a4_sim'], 2),
        'w4a4_sim_vs_bf16': round(ips['w4a4_sim'] / ips['bf16'], 4),
        'bf16_images_per_sec': round(ips['bf16'], 2),
        'w4a4_serving_images_per_sec': round(ips['w4a4_serving'], 2),
        'w4a4_packed_images_per_sec': round(ips['w4a4_packed'], 2),
        'mfu_int8': round(rep.compute_util, 4),
        'bandwidth_util': round(rep.bandwidth_util, 4),
        'mfu_ceiling_mem': round(rep.mem_roofline_mfu, 4),
        'bound': rep.bound,
        'bytes_counted': round(rep.bytes_per_call / 1e9, 4),
        'w4a4_packed_mfu_int8': round(rep4.compute_util, 4),
        'w4a4_packed_bytes_counted': round(rep4.bytes_per_call / 1e9, 4),
        'w4a4_packed_mfu_ceiling_mem': round(rep4.mem_roofline_mfu, 4),
        'int8_resident_offenders': r['int8_resident_offenders'],
        'serving_idle_share': rows['serving'].get('device_idle_share'),
        'w4a4_packed_idle_share': rows['w4a4_packed'].get('device_idle_share'),
        'batch_sweep': sweep_ips,
        'serving_ips_spread': spread,
        **mob,
        **smoke,
        'batch': batch, 'dtype': 'bfloat16', 'card': card,
        'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
    }, launches


def main(**kwargs):
    """Run the bench (``BENCH_BATCH`` sets the batch, 128 by default) and
    print the headline as the last line; returns the exit code."""
    kwargs.setdefault('batch', int(os.environ.get('BENCH_BATCH', '128')))
    try:
        headline, _ = run(**kwargs)
    except BenchFailure as e:
        cause = e.__cause__
        traceback.print_exception(type(cause), cause, cause.__traceback__, file=sys.stderr)
        print(f'bench FAILED in section {e.args[0]}: {type(cause).__name__}: {cause}',
              file=sys.stderr)
        return 1
    print(json.dumps(headline))
    return 0


if __name__ == '__main__':
    sys.exit(main())
