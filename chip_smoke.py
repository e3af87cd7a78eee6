"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the shapes the main path gives it, drives
the main path (ResNet-50 W4A4 headline recipe at 224x224, batch 64: weight
pass, statistics collection, .npz round trip, qparam freeze, frozen
evaluation, one dynamic forward) and checks that it went through the kernels.
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
from cnn_quantization_tpu_torch.ops.kernels import build
from cnn_quantization_tpu_torch.ops.kernels import fake_quant as fq
from cnn_quantization_tpu_torch.ops.quant_math import affine_qparams

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
HEADLINE = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                bias_corr_weight=True)
STAGE1_ACT = (64, 256, 56, 56)   # ResNet-50 layer1 output at 224x224, batch 64
REPLACES = 'cnn_quantization_tpu/ops/kernels/fake_quant.py:63'


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


def cuda_ms(fn, iters=30, warmup=3):
    """Mean time of ``fn()`` on the card, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def profile_frozen_step(engine, params_q, qparams, stats, images):
    """Where the time of one warm frozen-eval forward goes: device time by
    kernel (torch.profiler), the device's busy share of the host wall time,
    and the fake-quant kernel's share of the device time."""
    from torch.profiler import ProfilerActivity, profile
    fwd = engine.make_forward(qparams=qparams)
    for _ in range(2):
        fwd(params_q, stats, images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd(params_q, stats, images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = {}
    for ev in prof.key_averages():
        # device records only (kernels, copies): a host op's entry repeats the
        # time of the kernels it launched; 'Activity Buffer Request' is
        # CUPTI's bookkeeping record, not device work
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key == 'Activity Buffer Request':
            continue
        device_us[ev.key] = device_us.get(ev.key, 0) + ev.self_device_time_total
    busy_ms = sum(device_us.values()) / 1e3
    fq_ms = sum(us for k, us in device_us.items() if 'fake_quant_kernel' in k) / 1e3
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    return dict(batch=int(images.shape[0]), wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                fake_quant_ms=fq_ms, fake_quant_share_of_device=fq_ms / max(busy_ms, 1e-9),
                images_per_sec_warm=images.shape[0] / wall_ms * 1e3,
                top_device_ms=[[k[:80], us / 1e3] for k, us in top])


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
    log = build.build_library('fake_quant')[1]
    ptxas = [ln.strip() for ln in log.splitlines() if 'registers' in ln or 'spill' in ln]
    emit('build', seconds=time.perf_counter() - t0, ptxas=ptxas)

    max_err, act, (d_pc, o_pc, q_pc) = kernel_vs_plain(device)
    emit('card_vs_cpu', **card_vs_cpu(device))

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

    # the kernels line: the main path's per-channel activation fake-quant at
    # the stage-1 shape
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
    print(json.dumps({'card': card, 'kernels': [{
        'name': 'fake_quant', 'route': 'cuda',
        'source': 'cnn_quantization_tpu_torch/csrc/fake_quant.cu',
        'replaces': REPLACES, 'modes': ['affine', 'stochastic', 'reference_per_tensor'],
        'launches': rep['launches'], 'max_abs_err': max_err, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': library_ms}]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f'chip_smoke FAILED: {e}', file=sys.stderr)
        sys.exit(1)
