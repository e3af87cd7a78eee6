"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc per
source, started together), holds each against its plain PyTorch version at the
shapes the main paths give it, and drives both main paths at 224x224, batch
64, checking that each went through its kernels:

  * simulation: ResNet-50 W4A4 headline recipe (weight pass, statistics
    collection, .npz round trip, qparam freeze, frozen evaluation, one dynamic
    forward) through the fake-quant kernel;
  * true-int8 serving: ResNet-50 W8A8 (weight pass, serving preparation,
    scale freeze, frozen evaluation; one forward each for ACIQ calibration,
    the W4A4 grid, the space-to-depth stem and dynamic scales) through the
    int8 GEMM and int8 conv kernels.

Each phase prints one JSON line; the last two lines are the ``kernels`` table
and ``{"ok": true, "device": ...}``.  Any failed check exits non-zero before
those lines.  Without a CUDA device, or without the rest of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from cnn_quantization_tpu_torch.calib.calibrator import (collect_statistics, load_stats,
                                                         save_stats)
from cnn_quantization_tpu_torch.data.synthetic import synthetic_batches
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.engine.evaluate import evaluate
from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models.layers import QConv, QLinear, QMaxPool, QTensor
from cnn_quantization_tpu_torch.ops.kernels import build
from cnn_quantization_tpu_torch.ops.kernels import fake_quant as fq
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.ops.quant_math import affine_qparams

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
INT8_OPS = 1979e12          # H100 SXM int8 tensor cores, dense
SOURCES = ('fake_quant', 'int8_gemm', 'int8_conv')
W8A8 = dict(qtype='int8', qweight='int8')
W4A4 = dict(qtype='int4', qweight='int4')
HEADLINE = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                bias_corr_weight=True)
STAGE1_ACT = (64, 256, 56, 56)   # ResNet-50 layer1 output at 224x224, batch 64
REPLACES = 'cnn_quantization_tpu/ops/kernels/fake_quant.py:63'
REPLACES_GEMM = 'cnn_quantization_tpu/ops/kernels/int_matmul.py:58'
REPLACES_CONV = 'cnn_quantization_tpu/ops/kernels/int_conv.py:63'
# the serving path's own shapes at 224x224, batch 64 (M = batch * H * W)
GEMM_SHAPES = ((200704, 64, 256), (200704, 256, 64), (3136, 512, 2048), (3136, 2048, 512),
               (64, 2048, 1000))
# (input NCHW, out channels, kernel, stride, padding, groups, per-group scale vector)
CONV_SHAPES = {
    '3x3_s1_c64': ((64, 64, 56, 56), 64, 3, 1, 1, 1, False),
    '3x3_s2_c128': ((64, 128, 56, 56), 128, 3, 2, 1, 1, False),
    '3x3_s1_c512': ((64, 512, 7, 7), 512, 3, 1, 1, 1, False),
    '1x1_s2_c256': ((64, 256, 56, 56), 512, 1, 2, 0, 1, False),
    's2d_stem': ((64, 12, 115, 115), 64, 4, 1, 0, 1, False),
    'grouped_32': ((64, 128, 56, 56), 128, 3, 1, 1, 32, True),
    'depthwise': ((64, 96, 28, 28), 96, 3, 2, 1, 96, True),
}
TIMED_GEMMS = ((200704, 256, 64), (3136, 512, 2048))
TIMED_CONVS = ('3x3_s1_c64', '3x3_s1_c512')


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def card_name_and_power():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=30, warmup=3, head_start=True):
    """Mean time of ``fn()`` on the card, by CUDA events around ``iters`` calls.
    The device first spins for some 25 ms, so the host has queued every call
    before the first one starts: the events then bracket device work alone.
    Without ``head_start`` a call shorter than the host's time to launch it
    reads as that launch time instead."""
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


def fake_quant_bound_ms(x, n_params):
    """The least time for one fake-quant of ``x``: each input read once, each
    output written once (bytes), against ~6 float32 operations per element."""
    nbytes = 2 * x.numel() * x.element_size() + 4 * n_params
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * x.numel() / FP32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def per_channel_params(x, dim, gen, zero_bit_every=0):
    dims = tuple(i for i in range(x.ndim) if i != dim)
    mn, mx = x.amin(dim=dims), x.amax(dim=dims)
    bits = torch.randint(1, 5, mn.shape, generator=gen, device='cpu').float()
    if zero_bit_every:
        bits[::zero_bit_every] = 0
    qmax = (torch.pow(2.0, bits) - 1).to(x.device)
    return mx - mn, mn, qmax


def kernel_vs_plain(device):
    """Deterministic fp32 cases must be bit-identical to the plain version;
    bf16 within one grid step; stochastic by its statistics (bench.py:391-418)."""
    gen = torch.Generator().manual_seed(0)
    act = torch.randn(STAGE1_ACT, generator=gen).to(device).contiguous(
        memory_format=torch.channels_last)
    w1 = torch.randn((2048, 512, 1, 1), generator=gen).to(device)
    w3 = torch.randn((512, 512, 3, 3), generator=gen).to(device)
    d_pc, o_pc, q_pc = per_channel_params(act, 1, gen, zero_bit_every=7)
    dev = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    cases = {
        'a_per_tensor': (act, act.amax() - act.amin(), act.amin(), dev(15.0), None),
        'a_per_channel_scalar_qmax': (act, d_pc, o_pc, dev(15.0), 1),
        'a_per_channel_qmax_0bit': (act, d_pc, o_pc, q_pc, 1),
        'a_weight_1x1': (w1, *per_channel_params(w1, 0, gen), 0),
        'a_weight_3x3': (w3, *per_channel_params(w3, 0, gen)[:2], dev(15.0), 0),
    }
    errs = {}
    for name, (x, d, o, q, ch) in cases.items():
        got = fq.fake_quant_fused(x, d, o, q, channel_dim=ch)
        want = fq.fake_quant_fused_plain(x, d, o, q, channel_dim=ch)
        errs[name] = float((got - want).abs().max())
    semantics = {'c_straddles': (act.amax() - act.amin(), act.amin()),
                 'c_positive': (dev(3.0), dev(0.25)),
                 'c_empty_range': (dev(0.0), dev(1.5))}
    for name, (d, o) in semantics.items():
        got = fq.fake_quant_kernel_semantics_fused(act, d, o, 8)
        want = fq.fake_quant_kernel_semantics_plain(act, d, o, 8)
        errs[name] = float((got - want).abs().max())
    check(all(v == 0.0 for v in errs.values()), f'kernel != plain (fp32): {errs}')

    # bf16: each element within one grid step of its own channel (the scale
    # the kernel is given; a 0-bit channel's grid is one point, so its step is
    # the 1e-8 scale floor and it must match exactly)
    bf = act.bfloat16()
    got = fq.fake_quant_fused(bf, d_pc, o_pc, q_pc, channel_dim=1).float()
    want = fq.fake_quant_fused_plain(bf, d_pc, o_pc, q_pc, channel_dim=1).float()
    step = affine_qparams(d_pc, o_pc, q_pc)[0].view(1, -1, 1, 1)
    bf_diff = (got - want).abs()
    bf_err = float(bf_diff.max())
    bf_over = int((bf_diff > step).sum())
    check(bf_over == 0, f'bf16 kernel: {bf_over} elements off by more than their '
                        f"channel's grid step (max abs err {bf_err})")

    n, delta, qmax = 512 * 1024, 4.0, 15.0
    x = torch.rand((n // 256, 256), generator=gen).to(device) * delta
    a = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=7)
    a2 = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=7)
    b = fq.fake_quant_fused(x, delta, 0.0, qmax, stochastic=True, seed=8)
    det = fq.fake_quant_fused(x, delta, 0.0, qmax)
    bias = float((a - x).mean())
    se = delta / qmax / np.sqrt(12.0 * n)
    p_det, p_seed = float((a != det).float().mean()), float((a != b).float().mean())
    sto = {'mean_bias': bias, 'bias_tol_6se': 6 * se, 'p_ne_det': p_det,
           'p_seed7_ne_seed8': p_seed, 'same_seed_identical': bool(torch.equal(a, a2))}
    check(abs(bias) < 6 * se and 0.17 < p_det < 0.33 and 0.25 < p_seed < 0.42
          and sto['same_seed_identical'], f'stochastic statistics out of bounds: {sto}')
    emit('kernel_vs_plain', max_abs_err_fp32=errs, bf16_max_abs_err=bf_err,
         bf16_elements_over_own_grid_step=bf_over, stochastic=sto)
    return max(errs.values()), act, (d_pc, o_pc, q_pc)


def card_vs_cpu(device, arch='resnet18', size=64):
    """The same seeded weights and input on the card (kernels) and on the CPU
    (plain versions): the weight pass within 1e-5 relative per tensor, float
    logits within 1e-4 (cuDNN and CPU convs round differently); the W4A4
    logits are reported, since 4-bit grids amplify such differences."""
    x = next(synthetic_batches(2, 1, size=size, seed=1))[0]
    runs = {}
    for dev in (device, torch.device('cpu')):
        model, meta = build_model(arch, device=dev, seed=0)
        params = dict(model.state_dict())
        eng = QuantEngine(model, QuantPolicy(arch=arch, **HEADLINE), meta)
        params_q = eng.quantize_params(params)
        fp32, _ = QuantEngine(model, QuantPolicy(arch=arch), meta).make_forward()(params, None, x)
        w4a4, _ = eng.make_forward()(params_q, None, x)
        runs[dev.type] = ({k: v.cpu() for k, v in params_q.items()}, fp32.cpu(), w4a4.cpu())
    (pq_c, fp_c, q_c), (pq_h, fp_h, q_h) = runs[device.type], runs['cpu']
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    w_err = max(rel(pq_c[k], pq_h[k]) for k in pq_h)
    out = dict(arch=arch, input_size=size, weight_pass_max_rel=w_err,
               fp32_logits_rel=rel(fp_c, fp_h), w4a4_logits_rel=rel(q_c, q_h),
               w4a4_argmax_equal=bool(torch.equal(q_c.argmax(-1), q_h.argmax(-1))))
    check(w_err <= 1e-5 and out['fp32_logits_rel'] <= 1e-4
          and q_c.shape == (2, 1000) and bool(torch.isfinite(q_c).all()),
          f'card vs CPU: {out}')
    return out


def drive_main_path(device, *, arch='resnet50', size=224, batch=64, eval_batches=4):
    """The port's main path through the entry points a user calls.  Returns
    (engine, quantized params, frozen qparams, stats, one batch, report)."""
    model, meta = build_model(arch, device=device, seed=0)
    params = dict(model.state_dict())
    engine = QuantEngine(model, QuantPolicy(arch=arch, **HEADLINE), meta)
    batches = list(synthetic_batches(batch, eval_batches, size=size, seed=12345))
    sites = discover_sites(model, (1, 3, size, size))
    n_weights = sum(1 for k, v in params.items() if k.endswith('.weight') and v.ndim in (2, 4))
    # one launch per weight, three per site and collect batch (the error
    # columns of -sm collect), one per site and forward
    predicted = n_weights + 3 * len(sites) * 2 + len(sites) * (eval_batches + 1)

    fq.fake_quant_fused.launches = 0
    t0 = time.perf_counter()
    params_q = engine.quantize_params(params)
    summary = collect_statistics(engine.make_collect(err_bits=4), params, batches[:2])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f'{arch}_stats.npz')
        save_stats(path, summary)
        stats = load_stats(path)
    qparams = engine.freeze_qparams(stats, input_shape=(1, size, size, 3))
    res = evaluate(engine, params_q, batches, stats=stats, qparams=qparams)
    logits, _ = engine.make_forward()(params_q, None, batches[0][0])
    finite = bool(torch.isfinite(logits).all())
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = fq.fake_quant_fused.launches

    round_trip = all(np.array_equal(stats[s][k], summary[s][k]) for s in summary
                     for k in summary[s])
    report = dict(arch=arch, input_size=size, batch=batch, sites=len(sites),
                  frozen_sites=len(qparams), weights=n_weights, launches=launches,
                  predicted_launches=predicted, top1=res['top1'], top5=res['top5'],
                  loss=res['loss'], images_per_sec=res['images_per_sec'],
                  dynamic_logits_finite=finite, npz_round_trip=round_trip,
                  main_path_wall_s=wall)
    return engine, params_q, qparams, stats, batches[0][0], report


def end_to_end_kernel_vs_plain(engine, params_q, qparams, stats, images):
    """The same params and batch through the port with the kernel and with
    the plain version, deterministic cuDNN: argmax equal, logits within 1e-3."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    for name, kw, st in (('frozen', dict(qparams=qparams), stats), ('dynamic', {}, None)):
        fwd = engine.make_forward(**kw)
        kern, _ = fwd(params_q, st, images)
        with mock.patch.object(fq, 'fake_quant_fused', fq.fake_quant_fused_plain), \
                mock.patch.object(fq, 'fake_quant_kernel_semantics_fused',
                                  fq.fake_quant_kernel_semantics_plain):
            plain, _ = fwd(params_q, st, images)
        rel = float((kern - plain).norm() / plain.norm())
        same = bool(torch.equal(kern.argmax(-1), plain.argmax(-1)))
        out[name] = {'rel_err': rel, 'argmax_equal': same}
        check(same and rel <= 1e-3, f'{name}: kernel vs plain logits {out[name]}')
    return out


def int8_codes(shape, qmax, gen, device):
    return torch.randint(-qmax, qmax + 1, shape, generator=gen, dtype=torch.int8).to(device)


def gemm_case(m, k, n, qmax, gen, device):
    """A GEMM of the serving path: int8 activations [M, K] against an
    [out, in] weight as stored, handed over as its transposed view."""
    a = int8_codes((m, k), qmax, gen, device)
    bt = int8_codes((n, k), qmax, gen, device)
    alpha = (torch.rand(n, generator=gen) * 1e-3 + 1e-4).to(device)
    beta = torch.randn(n, generator=gen).to(device)
    return a, bt.t(), alpha, beta


def conv_case(name, qmax, gen, device):
    """A conv of the serving path: int8 codes in channels_last memory, OIHW
    codes with their scales, a scalar or per-group activation scale."""
    shape, o, k, s, p, groups, vector = CONV_SHAPES[name]
    cl = torch.channels_last
    x = int8_codes(shape, qmax, gen, device).contiguous(memory_format=cl)
    w = int8_codes((o, shape[1] // groups, k, k), qmax, gen, device).contiguous(memory_format=cl)
    w_scale = (torch.rand(o, generator=gen) * 1e-2 + 1e-3).to(device)
    bias = torch.randn(o, generator=gen).to(device)
    if vector:
        gs = torch.rand(groups, generator=gen) * 0.1 + 0.01
        act_scale = gs.repeat_interleave(shape[1] // groups).to(device)
    else:
        act_scale = torch.full((), 0.05, device=device)
    return (x, w, w_scale, bias), dict(strides=(s, s), padding=(p, p), groups=groups,
                                       act_scale=act_scale)


def bf16_over_one_ulp(got, want):
    """Elements further from the plain version than one bf16 ulp (2^-7
    relative: bf16 keeps 8 significant bits)."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > want.abs() * 2.0 ** -7 + 1e-30).sum())


def int8_kernels_vs_plain(device):
    """Both int8 kernels against their plain versions at the serving path's
    shapes, on both code grids.  The int32 sums are exact and the epilogue
    rounds each operation as the plain version does, so float32 outputs must
    be bit-identical; bf16 within one bf16 ulp."""
    gen = torch.Generator().manual_seed(1)
    gemm_err, conv_err, bf16_over = {}, {}, 0
    for m, k, n in GEMM_SHAPES:
        for qmax in (127, 7):
            a, b, alpha, beta = gemm_case(m, k, n, qmax, gen, device)
            for relu in (False, True):
                for dt in (torch.float32, torch.bfloat16):
                    got = im.int8_matmul_dequant(a, b, alpha, beta, fuse_relu=relu, out_dtype=dt)
                    want = im.int8_matmul_dequant_plain(a, b, alpha, beta, fuse_relu=relu,
                                                        out_dtype=dt)
                    if dt == torch.float32:
                        key = f'{m}x{k}x{n}'
                        err = float((got - want).abs().max())
                        gemm_err[key] = max(gemm_err.get(key, 0.0), err)
                    else:
                        bf16_over += bf16_over_one_ulp(got, want)
    for name in CONV_SHAPES:
        for qmax in (127, 7):
            args, kw = conv_case(name, qmax, gen, device)
            for dt in (torch.float32, torch.bfloat16):
                got = ic.int8_conv(*args, fuse_relu=qmax == 7, out_dtype=dt, **kw)
                with mock.patch.object(ic, 'int8_conv_dequant', ic.int8_conv_dequant_plain):
                    want = ic.int8_conv(*args, fuse_relu=qmax == 7, out_dtype=dt, **kw)
                if dt == torch.float32:
                    err = float((got - want).abs().max())
                    conv_err[name] = max(conv_err.get(name, 0.0), err)
                else:
                    bf16_over += bf16_over_one_ulp(got, want)
    torch.cuda.synchronize()
    emit('int8_kernels_vs_plain', gemm_max_abs_err_fp32=gemm_err,
         conv_max_abs_err_fp32=conv_err, bf16_elements_over_one_ulp=bf16_over)
    check(all(v == 0.0 for v in gemm_err.values()), f'int8 GEMM != plain (fp32): {gemm_err}')
    check(all(v == 0.0 for v in conv_err.values()), f'int8 conv != plain (fp32): {conv_err}')
    check(bf16_over == 0, f'{bf16_over} bf16 outputs off by more than one ulp')
    return max(gemm_err.values()), max(conv_err.values())


def rel_err(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def serving_card_vs_cpu(device, arch='resnet18', size=64):
    """The serving path on the card (kernels) and on the CPU (plain versions)
    from one set of quantized weights: prepared codes equal, frozen scales
    within 1e-5 relative, frozen W8A8 logits finite and within 0.03 of the
    float logits of the same weights (the JAX package's bound at this size)."""
    batches = list(synthetic_batches(2, 2, size=size, seed=1))
    x = batches[0][0]
    cpu = torch.device('cpu')
    model, meta = build_model(arch, device=cpu, seed=0)
    pq_host = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta).quantize_params(
        dict(model.state_dict()))
    runs = {}
    for dev in (device, cpu):
        model, meta = build_model(arch, device=dev, seed=0)
        eng = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta)
        pq = {k: v.to(dev) for k, v in pq_host.items()}
        sp = eng.prepare_serving_params(pq)
        scales = eng.freeze_serving_scales(sp, batches)
        logits, _ = eng.make_forward(quantized='serving_int8', act_scales=scales)(sp, None, x)
        fp32, _ = eng.make_forward(quantized=False)(pq, None, x)
        runs[dev.type] = ({k: v.cpu() for k, v in sp.items()}, scales, logits.cpu(), fp32.cpu())
    (sp_c, sc_c, l_c, fp_c), (sp_h, sc_h, l_h, _) = runs[device.type], runs['cpu']
    codes_equal = all(torch.equal(sp_c[k], sp_h[k]) for k in sp_h if sp_h[k].dtype == torch.int8)
    scales_equal = all(torch.equal(sp_c[k], sp_h[k]) for k in sp_h if k.endswith('.w_scale'))
    scale_err = max(float(np.max(np.abs(np.asarray(sc_c[k]) - sc_h[k]) / sc_h[k])) for k in sc_h)
    out = dict(arch=arch, input_size=size, prepared_codes_equal=codes_equal,
               w_scales_equal=scales_equal, frozen_sites=len(sc_c),
               frozen_scales_max_rel=scale_err, logits_rel_card_vs_cpu=rel_err(l_c, l_h),
               argmax_equal_card_vs_cpu=bool(torch.equal(l_c.argmax(-1), l_h.argmax(-1))),
               logits_rel_to_float=rel_err(l_c, fp_c),
               argmax_equal_to_float=bool(torch.equal(l_c.argmax(-1), fp_c.argmax(-1))))
    emit('serving_card_vs_cpu', **out)
    check(codes_equal and scales_equal and set(sc_c) == set(sc_h),
          f'serving preparation differs between card and CPU: {out}')
    check(scale_err <= 1e-5, f'frozen serving scales differ between card and CPU: {out}')
    check(l_c.shape == (2, 1000) and bool(torch.isfinite(l_c).all())
          and out['logits_rel_to_float'] < 0.03, f'serving logits: {out}')


def serving_launch_table(model, s2d_stem=False):
    """(int8 GEMM launches, int8 conv launches) of one serving forward, from
    the model's modules and the routing rule: a 1x1 stride-1 unpadded
    ungrouped conv and every linear is a GEMM, every other conv goes to the
    conv kernel, and the in_ch == 3 stem stays a float conv unless it was
    space-to-depth transformed."""
    gemm = conv = 0
    for m in model.modules():
        if isinstance(m, QLinear):
            gemm += 1
        elif isinstance(m, QConv):
            if m.in_ch == 3:
                conv += int(s2d_stem)
            elif (tuple(m.weight.shape[2:]), m.strides, m.padding, m.groups) \
                    == ((1, 1), (1, 1), (0, 0), 1):
                gemm += 1
            else:
                conv += 1
    return gemm, conv


def drive_serving_path(device, *, arch='resnet50', size=224, batch=64, eval_batches=4):
    """The true-int8 serving path through the entry points a user calls:
    weight pass, serving preparation, scale freeze (max, 2 batches), frozen
    evaluation; then one forward each with ACIQ-calibrated scales, on the
    W4A4 grid, with the space-to-depth stem and with dynamic scales.  Returns
    (engine, prepared params, frozen scales, weight-quantized params, one
    batch, report)."""
    model, meta = build_model(arch, device=device, seed=0)
    params = dict(model.state_dict())
    batches = list(synthetic_batches(batch, eval_batches, size=size, seed=12345))
    images = batches[0][0]
    gemm_per, conv_per = serving_launch_table(model)
    _, conv_s2d = serving_launch_table(model, s2d_stem=True)

    def serve(eng, sp, scales):
        logits, aux = eng.make_forward(quantized='serving_int8', act_scales=scales)(
            sp, None, images)
        return bool(torch.isfinite(logits).all()) and logits.shape == (batch, 1000), aux

    im.int8_matmul_dequant.launches = 0
    ic.int8_conv_dequant.launches = 0
    t0 = time.perf_counter()
    eng = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta)
    pq = eng.quantize_params(params)
    sp = eng.prepare_serving_params(pq)
    scales = eng.freeze_serving_scales(sp, batches, max_batches=2, mode='max')
    res = evaluate(eng, sp, batches, quantized='serving_int8', act_scales=scales)
    finite = {}
    aciq = eng.freeze_serving_scales(sp, batches, max_batches=2, mode='aciq')
    finite['aciq'], _ = serve(eng, sp, aciq)
    eng4 = QuantEngine(model, QuantPolicy(arch=arch, **W4A4), meta)
    sp4 = eng4.prepare_serving_params(eng4.quantize_params(params))
    finite['w4a4'], _ = serve(eng4, sp4, eng4.freeze_serving_scales(sp4, batches, max_batches=2))
    sp_s2d = eng.prepare_serving_params(pq, s2d_stem=True)
    scales_s2d = eng.freeze_serving_scales(sp_s2d, batches, max_batches=2)
    finite['s2d_stem'], _ = serve(eng, sp_s2d, scales_s2d)
    finite['dynamic'], recorded = serve(eng, sp, None)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    gemm_launches = im.int8_matmul_dequant.launches
    conv_launches = ic.int8_conv_dequant.launches

    # 2 calibration forwards per freeze; the s2d stem adds one conv launch
    forwards = (2 + eval_batches) + (2 + 1) + (2 + 1) + 1
    forwards_s2d = 2 + 1
    predicted_gemm = gemm_per * (forwards + forwards_s2d)
    predicted_conv = conv_per * forwards + conv_s2d * forwards_s2d
    s2d_codes = sp_s2d['conv1.weight']
    report = dict(arch=arch, input_size=size, batch=batch, grid='W8A8',
                  gemm_per_forward=gemm_per, conv_per_forward=conv_per,
                  conv_per_forward_s2d_stem=conv_s2d, forwards=forwards + forwards_s2d,
                  gemm_launches=gemm_launches, predicted_gemm_launches=predicted_gemm,
                  conv_launches=conv_launches, predicted_conv_launches=predicted_conv,
                  frozen_sites=len(scales), frozen_sites_s2d_stem=len(scales_s2d),
                  dynamic_recorded_sites=len(recorded),
                  s2d_stem_kernel=[str(s2d_codes.dtype), list(s2d_codes.shape)],
                  w4a4_max_code=int(sp4['layer1.0.conv1.weight'].abs().max()),
                  top1=res['top1'], top5=res['top5'], loss=res['loss'],
                  images_per_sec=res['images_per_sec'], finite=finite,
                  serving_path_wall_s=wall)
    return eng, sp, scales, pq, images, report


def int8_resident_flow(eng, sp, scales, pq, images):
    """With frozen scales the block input is quantized once: every block's
    conv1 and downsample conv receive a QTensor, the max-pool runs on codes.
    Also the relative error of the frozen logits to the float logits of the
    same weights (reported; bounded at resnet18 64x64 in serving_card_vs_cpu)."""
    got_codes, pool_on_codes = {}, []
    conv_forward, pool_forward = QConv.forward, QMaxPool.forward

    def conv(self, x, ctx, **kw):
        got_codes[self.site.id] = isinstance(x, QTensor)
        return conv_forward(self, x, ctx, **kw)

    def pool(self, x, ctx):
        pool_on_codes.append(isinstance(x, QTensor) and x.codes.dtype == torch.int8)
        return pool_forward(self, x, ctx)

    with mock.patch.object(QConv, 'forward', conv), mock.patch.object(QMaxPool, 'forward', pool):
        logits, aux = eng.make_forward(quantized='serving_int8', act_scales=scales)(
            sp, None, images)
    fp32, _ = eng.make_forward(quantized=False)(pq, None, images)
    block_inputs = [m.site.id for name, m in eng.model.named_modules()
                    if isinstance(m, QConv) and name.endswith(('.conv1', '.downsample.0'))]
    missing = [s for s in block_inputs if not got_codes.get(s)]
    out = dict(block_input_convs=len(block_inputs), not_fed_codes=missing,
               maxpool_on_codes=pool_on_codes, frozen_forward_records=len(aux),
               logits_rel_to_float=rel_err(logits, fp32),
               argmax_agreement_with_float=float(
                   (logits.argmax(-1) == fp32.argmax(-1)).float().mean()))
    emit('serving_int8_resident', **out)
    check(not missing and pool_on_codes == [True] and not aux,
          f'serving forward is not int8-resident: {out}')


def serving_kernels_vs_plain_end_to_end(eng, sp, scales, images):
    """The same prepared params, scales and batch through the port with the
    kernels and with both wrappers patched to their plain versions.  The
    integer part is exact and the float stem is the same cuDNN call in both
    (deterministic algorithms), so: relative error <= 1e-6, argmax equal."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    fwd = eng.make_forward(quantized='serving_int8', act_scales=scales)
    kern, _ = fwd(sp, None, images)
    launched = im.int8_matmul_dequant.launches, ic.int8_conv_dequant.launches
    with mock.patch.object(im, 'int8_matmul_dequant', im.int8_matmul_dequant_plain), \
            mock.patch.object(ic, 'int8_conv_dequant', ic.int8_conv_dequant_plain):
        plain, _ = fwd(sp, None, images)
    plain_launched_none = launched == (im.int8_matmul_dequant.launches,
                                       ic.int8_conv_dequant.launches)
    out = dict(rel_err=rel_err(kern, plain), plain_run_launched_no_kernel=plain_launched_none,
               argmax_equal=bool(torch.equal(kern.argmax(-1), plain.argmax(-1))))
    emit('serving_kernels_vs_plain_end_to_end', **out)
    check(out['argmax_equal'] and out['rel_err'] <= 1e-6 and plain_launched_none,
          f'serving kernels vs plain: {out}')


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


def profile_frozen_step(engine, params_q, qparams, stats, images):
    """Where the time of one warm frozen-eval forward goes: device time by
    kernel (torch.profiler), the device's busy share of the host wall time,
    and the fake-quant kernel's share of the device time."""
    fwd = engine.make_forward(qparams=qparams)
    for _ in range(2):
        fwd(params_q, stats, images)
    torch.cuda.synchronize()
    wall_ms, device_us = device_time_by_kernel(lambda: fwd(params_q, stats, images))
    busy_ms = sum(device_us.values()) / 1e3
    fq_ms = sum(us for k, us in device_us.items() if 'fake_quant_kernel' in k) / 1e3
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    return dict(batch=int(images.shape[0]), wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                fake_quant_ms=fq_ms, fake_quant_share_of_device=fq_ms / max(busy_ms, 1e-9),
                images_per_sec_warm=images.shape[0] / wall_ms * 1e3,
                top_device_ms=[[k[:80], us / 1e3] for k, us in top])


def profile_serving_step(eng, sp, scales, images):
    """Where the time of one warm frozen serving forward goes: device time in
    the int8 GEMM, in the int8 conv, in PyTorch's elementwise kernels (the
    quantize/dequantize chains, ReLU and the residual adds) and the rest."""
    fwd = eng.make_forward(quantized='serving_int8', act_scales=scales)
    for _ in range(2):
        fwd(sp, None, images)
    torch.cuda.synchronize()
    wall_ms, device_us = device_time_by_kernel(lambda: fwd(sp, None, images))
    busy_ms = sum(device_us.values()) / 1e3

    def total_ms(*needles):
        return sum(us for k, us in device_us.items() if any(n in k for n in needles)) / 1e3

    gemm_ms, conv_ms = total_ms('DenseA'), total_ms('ConvA')
    elementwise_ms = total_ms('elementwise_kernel')
    copy_ms = total_ms('Memcpy')
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    return dict(batch=int(images.shape[0]), wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                int8_gemm_ms=gemm_ms, int8_conv_ms=conv_ms, elementwise_ms=elementwise_ms,
                memcpy_ms=copy_ms, other_ms=busy_ms - gemm_ms - conv_ms - elementwise_ms - copy_ms,
                int8_kernels_share_of_device=(gemm_ms + conv_ms) / max(busy_ms, 1e-9),
                elementwise_share_of_device=elementwise_ms / max(busy_ms, 1e-9),
                images_per_sec_warm=images.shape[0] / wall_ms * 1e3,
                top_device_ms=[[k[:80], us / 1e3] for k, us in top])


def int8_bound_ms(ops, nbytes):
    """The least time for an int8 product: its operations at the tensor
    cores' dense int8 rate, or its bytes (each input read once, each output
    written once) at the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def int8_timing(device, card):
    """Each int8 kernel at its heaviest shapes on the serving path: kernel,
    plain version, bound, and for the GEMM one library call (torch._int_mm:
    the int32 product only, no epilogue; the port never calls it).  PyTorch
    has no call that computes an int8 convolution.  No cache flush between
    launches: the largest shapes exceed the 50 MB L2, the late-stage ones fit
    and are found warm, as their producer leaves them on the path."""
    gen = torch.Generator().manual_seed(2)
    rows = {'int8_gemm': [], 'int8_conv': []}
    for m, k, n in TIMED_GEMMS:
        a, b, alpha, beta = gemm_case(m, k, n, 127, gen, device)
        ms = cuda_ms(lambda: im.int8_matmul_dequant(a, b, alpha, beta))
        host_paced_ms = cuda_ms(lambda: im.int8_matmul_dequant(a, b, alpha, beta),
                                head_start=False)
        plain_ms = cuda_ms(lambda: im.int8_matmul_dequant_plain(a, b, alpha, beta), iters=5,
                           warmup=1)
        library_ms = cuda_ms(lambda: torch._int_mm(a, b))
        ops, nbytes = 2 * m * n * k, m * k + k * n + 4 * m * n + 8 * n
        bound_ms, bound_by = int8_bound_ms(ops, nbytes)
        rows['int8_gemm'].append(dict(
            shape=f'[{m},{k}]x[{k},{n}]', out='float32', ms=ms, host_paced_ms=host_paced_ms,
            plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            tera_ops_per_s=ops / ms / 1e9, gb_per_s=nbytes / ms / 1e6))
    for name in TIMED_CONVS:
        (x, w, w_scale, bias), kw = conv_case(name, 127, gen, device)
        alpha = kw.pop('act_scale') * w_scale
        ms = cuda_ms(lambda: ic.int8_conv_dequant(x, w, alpha, bias, **kw))
        host_paced_ms = cuda_ms(lambda: ic.int8_conv_dequant(x, w, alpha, bias, **kw),
                                head_start=False)
        plain_ms = cuda_ms(lambda: ic.int8_conv_dequant_plain(x, w, alpha, bias, **kw), iters=5,
                           warmup=1)
        out = ic.int8_conv_dequant(x, w, alpha, bias, **kw)
        ops = 2 * out.numel() * w[0].numel()
        nbytes = x.numel() + w.numel() + 4 * out.numel() + 8 * w.shape[0]
        bound_ms, bound_by = int8_bound_ms(ops, nbytes)
        rows['int8_conv'].append(dict(
            shape=f'{list(x.shape)} * {list(w.shape)} stride {kw["strides"][0]}', out='float32',
            ms=ms, host_paced_ms=host_paced_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by,
            tera_ops_per_s=ops / ms / 1e9, gb_per_s=nbytes / ms / 1e6))
    emit('int8_timing', card=card, **rows)
    return rows


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda')
    card = card_name_and_power()
    kind = torch.cuda.get_device_name(0)
    # the first line is nvidia-smi's own "name, power.limit" line, verbatim;
    # every phase after it prints one JSON line
    print(card, flush=True)
    emit('device', nvidia_smi=card, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build_libraries(SOURCES)
    emit('build', seconds=time.perf_counter() - t0, sources={
        name: dict(seconds=secs, ptxas=[ln.strip() for ln in log.splitlines()
                                        if 'registers' in ln or 'spill' in ln])
        for name, (_, log, secs) in built.items()})

    max_err, act, (d_pc, o_pc, q_pc) = kernel_vs_plain(device)
    gemm_err, conv_err = int8_kernels_vs_plain(device)
    emit('card_vs_cpu', **card_vs_cpu(device))
    serving_card_vs_cpu(device)

    # ---- main path 1: W4A4 simulation through the fake-quant kernel
    engine, params_q, qparams, stats, images, rep = drive_main_path(device)
    emit('main_path', card=card, **rep)
    check(rep['launches'] > 0 and rep['launches'] == rep['predicted_launches'],
          f"fake-quant launches {rep['launches']} != predicted {rep['predicted_launches']}")
    check(np.isfinite([rep['top1'], rep['top5'], rep['loss']]).all()
          and rep['dynamic_logits_finite'], 'non-finite main-path output')
    check(rep['npz_round_trip'], 'stats .npz round trip changed values')
    check(rep['frozen_sites'] == rep['sites'], 'not every site froze')

    emit('frozen_step_profile', card=card,
         **profile_frozen_step(engine, params_q, qparams, stats, images))

    e2e = end_to_end_kernel_vs_plain(engine, params_q, qparams, stats, images)
    emit('end_to_end_kernel_vs_plain', **e2e)
    del engine, params_q, qparams, stats

    # ---- main path 2: true-int8 serving through the int8 GEMM and conv kernels
    eng, sp, scales, pq, images, srep = drive_serving_path(device)
    emit('serving_path', card=card, **srep)
    check(srep['gemm_launches'] > 0
          and srep['gemm_launches'] == srep['predicted_gemm_launches'],
          f"int8 GEMM launches {srep['gemm_launches']} != predicted "
          f"{srep['predicted_gemm_launches']}")
    check(srep['conv_launches'] > 0
          and srep['conv_launches'] == srep['predicted_conv_launches'],
          f"int8 conv launches {srep['conv_launches']} != predicted "
          f"{srep['predicted_conv_launches']}")
    check(np.isfinite([srep['top1'], srep['top5'], srep['loss']]).all()
          and all(srep['finite'].values()), f"non-finite serving output: {srep['finite']}")
    check(srep['dynamic_recorded_sites'] == srep['gemm_per_forward'] + srep['conv_per_forward']
          and srep['frozen_sites_s2d_stem'] == srep['frozen_sites'] + 1
          and srep['s2d_stem_kernel'] == ['torch.int8', [64, 12, 4, 4]]
          and srep['w4a4_max_code'] == 7, f'serving path bookkeeping: {srep}')
    int8_resident_flow(eng, sp, scales, pq, images)
    serving_kernels_vs_plain_end_to_end(eng, sp, scales, images)
    emit('serving_step_profile', card=card, **profile_serving_step(eng, sp, scales, images))
    del eng, sp, scales, pq

    # ---- kernel times at the main paths' shapes
    # fake-quant: the per-channel activation fake-quant at the stage-1 shape.
    # ``ms``: the kernel alone, from the scale/zero point the wrapper derives
    # (as the library call gets them); ``wrapper_ms`` adds that derivation
    args = (act, d_pc, o_pc, q_pc)
    scale, zp = affine_qparams(d_pc, o_pc, q_pc)
    ms = cuda_ms(lambda: fq.launch(act, scale, zp, q_pc, 1, fq.AFFINE))
    wrapper_ms = cuda_ms(lambda: fq.fake_quant_fused(*args, channel_dim=1))
    plain_ms = cuda_ms(lambda: fq.fake_quant_fused_plain(*args, channel_dim=1))
    zp_i = zp.clamp(0, 15).to(torch.int32)
    library_ms = cuda_ms(lambda: torch.fake_quantize_per_channel_affine(
        act, scale, zp_i, 1, 0, 15))
    bound_ms, bound_by = fake_quant_bound_ms(act, 3 * d_pc.numel())
    emit('fake_quant_timing', card=card, shape=list(STAGE1_ACT), dtype='float32',
         ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=library_ms,
         bound_ms=bound_ms, achieved_gb_per_s=2 * act.numel() * 4 / ms / 1e6)
    del act
    timing = int8_timing(device, card)

    def int8_row(name, source, replaces, launches, err):
        # the kernels line carries the heaviest shape; the other is in int8_timing
        t = timing[name][0]
        return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
                'shape': t['shape'], 'launches': launches, 'max_abs_err': err, 'ms': t['ms'],
                'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
                'bound_by': t['bound_by'], 'library_ms': t['library_ms']}

    print(json.dumps({'card': card, 'kernels': [
        {'name': 'fake_quant', 'route': 'cuda',
         'source': 'cnn_quantization_tpu_torch/csrc/fake_quant.cu',
         'replaces': REPLACES, 'modes': ['affine', 'stochastic', 'reference_per_tensor'],
         'launches': rep['launches'], 'max_abs_err': max_err, 'ms': ms,
         'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
         'library_ms': library_ms},
        int8_row('int8_gemm', 'cnn_quantization_tpu_torch/csrc/int8_gemm.cu', REPLACES_GEMM,
                 srep['gemm_launches'], gemm_err),
        int8_row('int8_conv', 'cnn_quantization_tpu_torch/csrc/int8_conv.cu', REPLACES_CONV,
                 srep['conv_launches'], conv_err)]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f'chip_smoke FAILED: {e}', file=sys.stderr)
        sys.exit(1)
