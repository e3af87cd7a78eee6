"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc per
source, started together), holds each against its plain PyTorch version at the
shapes the main paths give it, and drives the main paths at 224x224,
checking that each went through its kernels (five kernels in all: fake-quant,
int8 GEMM, int8 conv, int4-packed GEMM, stream copy).  The simulation and the
two serving paths run at batch 64:

  * simulation: ResNet-50 W4A4 headline recipe (weight pass, statistics
    collection, .npz round trip, qparam freeze, frozen evaluation, one dynamic
    forward) through the fake-quant kernel;
  * true-int8 serving: ResNet-50 W8A8 (weight pass, serving preparation,
    scale freeze, frozen evaluation; one forward each for ACIQ calibration,
    the W4A4 grid, the space-to-depth stem and dynamic scales) through the
    int8 GEMM and int8 conv kernels;
  * W4A4 packed serving: ResNet-50 W4A4 (weight pass, serving preparation,
    scale freeze with the packed grid, frozen packed evaluation; one forward
    each for stages (1,) and (2, 3) and for scales without the packed keys)
    through the int4-packed GEMM, the int8 conv and the int8 GEMM;
  * the rest of the simulation CLI: ``inference_sim.main`` in-process on
    ResNet-50 at batch 8 (phase ``cli_path``): KLD calibration (collect with
    the C++ threshold sweep, then use, frozen and with -me dynamic through
    the kernel's reference_per_tensor mode), mid-tread quantization,
    stochastic rounding (seeded) and the sweeps and outputs (-ep, -ct, -ms,
    -dd), each run's fake-quant launches by mode against the site table;
  * the rest of the zoo (phase ``zoo_path``): VGG-16, VGG-16-BN, AlexNet,
    SqueezeNet-1.0, GoogLeNet, DenseNet-121 and ShuffleNet at 224x224 and
    Inception-v3 at 299x299, full width, batch 32: the W4A4 headline
    simulation (weight pass, statistics on one batch, qparam freeze, two
    frozen batches; fake-quant launches by mode against the site table) and
    W8A8 serving (scales frozen on one batch, two frozen batches; integer
    launches by route against the route table), each held end to end against
    the plain versions on 4 images; VGG-16 mid-tread through the CLI;
  * the ImageNet loader's ``.npz`` route (phase ``data_path``): a
    preprocessed eval set of 256 seeded 224x224 images, ``inference_sim
    --data <npz>`` in process on ResNet-50, batch 64, W4A4 headline recipe,
    ``-sm collect`` then ``-sm use``: launches by mode against the site table,
    results and logits equal to ``evaluate`` on the same arrays; the
    class-folder route without PIL exits naming it;
  * the auxiliary tools (phase ``tools_path``): the k-means CLI on ResNet-50
    (4 bits, quantize and clip, with and without bias correction; at most 16
    values a leaf) and its ``.npz`` through ``inference_sim --weights``;
    ``golden_repro --smoke`` (six configs) and its ``w4a4_headline`` at
    224x224, batch 64; ``fake_quant_ste`` at ``[64,256,56,56]``, forward and
    gradient against the plain versions; ``cost_analysis`` of one W8A8
    serving forward at batch 64, its operations equal to ``count_work``'s;
  * the parallel layer (phase ``parallel_path``): a one-rank NCCL group on a
    1x1 mesh runs ``evaluate_sharded`` (W4A4 frozen simulation, W8A8 serving)
    equal to ``evaluate`` bit for bit, and the W8A8 serving tree goes through
    a sharded parameter checkpoint (DCP) bit for bit, logits included; two
    processes over gloo on the one card (``chip_smoke.py --parallel-worker
    ...``), meshes data=2/model=1 and data=1/model=2, run W8A8 serving with
    frozen scales, logits equal to one process's bit for bit, each rank's
    int8 launches by route against the route table of its sliced shapes,
    and save their shards into one checkpoint, which reads back whole equal
    to the unsharded tree and by mesh index equal to ``shard_params``;
  * eval-loop resume (phase ``resume_path``): ResNet-50 at batch 64, six
    batches from the host, the W4A4 headline with frozen qparams and W8A8
    serving with frozen scales, each run uninterrupted, interrupted at batch
    3 with a checkpoint every 2 batches, and resumed: top-1/top-5 equal,
    launches only for the batches run, no device value read inside the
    uninterrupted loop;
  * the recipes' accuracy ordering (phase ``accuracy_path``): the JAX
    package's ordering test on the port, its ResNet-18 trained on the card
    (1000 Adam steps at batch 128 on its synthetic heavy-tailed task), its
    six golden configurations through ``inference_sim`` on 2048 images at
    batch 256 (launches by mode and route against the tables), one batch
    through the kernels and their plain versions; the float-order band of
    the three 4-bit recipes (16 draws of one-ulp nudges of the trained
    weights through the kernels: top-1 mean, sd, min and max, and in how
    many draws each ordering assertion holds); all but W8A8 again on the
    CPU; the six assertions of the JAX test on the unperturbed network,
    card-vs-CPU top-1 within 0.2 points for fp32 and W8A8 serving and within
    the card band's mean +- max(4 sd, 4 images) for the 4-bit recipes;
  * the throughput bench (``python3 -m cnn_quantization_tpu_torch.bench``):
    ResNet-50 with bfloat16 activations at batch 128 (W4A4 simulation, bf16
    baseline, W8A8 serving, W4A4 serving plain and packed), the batch sweep,
    MobileNet-v2 serving with its per-channel depthwise scales, and the
    probes, among them the memory-rate probe through the stream-copy kernel.
    The bench runs twice: first with every kernel wrapper's first call of
    each distinct signature held against the plain version on the same
    inputs, then counted, every launch against the models' site tables.

The integer kernels have routes chosen by shape: the int8 GEMM TMA + wgmma or
mma.sync; the int8 conv direct depthwise, TMA im2col + wgmma or the mma.sync
implicit GEMM; the int4 GEMM TMA + wgmma or mma.sync.  ``int8_kernels_vs_plain``
and ``int4_kernel_vs_plain`` hold every route against the plain version, each
path's phase holds the launches by route against the route functions applied
to the model's modules, and ``int8_timing``/``int4_timing`` time each timed
shape on its route and on the mma.sync route beside it.  ``quantize_codes_timing``
times the float hand-off's codes kernel (``csrc/fake_quant.cu``) at the serving
models' largest entry tensors beside the plain composition it replaces; the
serving path counts its launches in the frozen evaluation (two a forward: the
stem output and the classifier's input).

Each phase prints one JSON line; the last two lines are the ``kernels`` table
(each path's launches; the slice-9 to slice-11 phases' as
``data_launches``, ``tools_launches``, ``parallel_launches``,
``resume_launches`` and ``accuracy_launches``) and ``{"ok": true, "device":
...}``.  Any failed check exits non-zero before those lines.  Without a CUDA
device, or without the rest of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import functools
import io
import json
import os
import sys
import tempfile
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from cnn_quantization_tpu_torch import bench
from cnn_quantization_tpu_torch.calib.calibrator import (collect_statistics, load_stats,
                                                         save_stats)
from cnn_quantization_tpu_torch.data.synthetic import (IMAGENET_MEAN, IMAGENET_STD,
                                                        synthetic_batches)
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.engine.evaluate import evaluate
from cnn_quantization_tpu_torch.engine.context import QuantizeContext, ServingInt8Context
from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models.layers import (PackedQTensor, QConv, QLinear, QMaxPool,
                                                      QTensor)
from cnn_quantization_tpu_torch.ops.kernels import build
from cnn_quantization_tpu_torch.ops.kernels import fake_quant as fq
from cnn_quantization_tpu_torch.ops.kernels import int4_matmul as i4
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.ops.kernels import stream_copy as sc
from cnn_quantization_tpu_torch.ops.quant_math import affine_qparams
from cnn_quantization_tpu_torch.utils import counters
from cnn_quantization_tpu_torch.utils.device import card_name_and_power
from cnn_quantization_tpu_torch.utils.profiling import device_ms as cuda_ms
from cnn_quantization_tpu_torch.utils.profiling import (cost_analysis, count_work,
                                                        device_ms_by_class, device_time_by_kernel,
                                                        kernel_class)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
INT8_OPS = 1979e12          # H100 SXM int8 tensor cores, dense
SOURCES = ('fake_quant', 'int8_gemm', 'int8_conv', 'int4_gemm', 'stream_copy')
W8A8 = dict(qtype='int8', qweight='int8')
W4A4 = dict(qtype='int4', qweight='int4')
HEADLINE = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                bias_corr_weight=True)
STAGE1_ACT = (64, 256, 56, 56)   # ResNet-50 layer1 output at 224x224, batch 64
REPLACES = 'cnn_quantization_tpu/ops/kernels/fake_quant.py:63'
REPLACES_GEMM = 'cnn_quantization_tpu/ops/kernels/int_matmul.py:58'
REPLACES_CONV = 'cnn_quantization_tpu/ops/kernels/int_conv.py:63'
# no TPU kernel: XLA fuses the codes of quantize_sym_int8 into their producer
REPLACES_CODES = 'cnn_quantization_tpu/ops/kernels/int_matmul.py:104'
# (M, K, N): the serving path's own shapes at 224x224, batch 64 (M = batch * H
# * W), the classifier at batch 128, three of MobileNet-v2's at batch 128: K =
# 24 (no multiple of 16: the mma.sync route and its byte-wise loader), N = 16
# and N = 24 (ragged column tiles), and a TMA route case ragged in M, N and K
GEMM_SHAPES = ((200704, 64, 256), (200704, 256, 64), (3136, 512, 2048), (3136, 2048, 512),
               (64, 2048, 1000), (128, 2048, 1000), (401408, 24, 144), (1605632, 32, 16),
               (401408, 144, 24), (3001, 272, 1000),
               # the zoo at batch 32: VGG's and AlexNet's first classifiers at M =
               # 32, SqueezeNet-1.0's conv classifier (13 x 13 rows an image, N =
               # 1000), DenseNet's 1x1 convs at K = 64 + 32j (blocks 1 and 4),
               # ShuffleNet's first 1x1 at K = 24 (the mma.sync route)
               (32, 25088, 4096), (32, 9216, 4096), (5408, 512, 1000), (100352, 96, 128),
               (1568, 992, 128), (100352, 24, 96))
# (input NCHW, out channels, kernel, stride, padding, groups, per-group scale
# vector); kernel and padding an int, or (height, width)
CONV_SHAPES = {
    '3x3_s1_c64': ((64, 64, 56, 56), 64, 3, 1, 1, 1, False),
    '3x3_s2_c128': ((64, 128, 56, 56), 128, 3, 2, 1, 1, False),
    '3x3_s1_c512': ((64, 512, 7, 7), 512, 3, 1, 1, 1, False),
    '1x1_s2_c256': ((64, 256, 56, 56), 512, 1, 2, 0, 1, False),
    's2d_stem': ((64, 12, 115, 115), 64, 4, 1, 0, 1, False),
    'grouped_32': ((64, 128, 56, 56), 128, 3, 1, 1, 32, True),
    'depthwise': ((64, 96, 28, 28), 96, 3, 2, 1, 96, True),
    # ResNet-50's 3x3 convs of stages 2-4 at batch 128, a stride-2 3x3 at C =
    # 64 and a ragged one (odd H and W, M = 630 no multiple of 128)
    '3x3_s1_c128_b128': ((128, 128, 28, 28), 128, 3, 1, 1, 1, False),
    '3x3_s1_c256_b128': ((128, 256, 14, 14), 256, 3, 1, 1, 1, False),
    '3x3_s1_c512_b128': ((128, 512, 7, 7), 512, 3, 1, 1, 1, False),
    '3x3_s2_c64': ((64, 64, 56, 56), 64, 3, 2, 1, 1, False),
    '3x3_s2_c64_ragged': ((3, 64, 29, 27), 64, 3, 2, 1, 1, False),
    # MobileNet-v2 at batch 128: its widest depthwise conv and a strided one
    'dw_s1_c144_b128': ((128, 144, 56, 56), 144, 3, 1, 1, 144, True),
    'dw_s2_c96_b128': ((128, 96, 112, 112), 96, 3, 2, 1, 96, True),
    # the direct depthwise route's masked path: C no multiple of 16, odd H and W
    'dw_s2_c40_odd': ((32, 40, 29, 27), 40, 3, 2, 1, 40, True),
    # the zoo at batch 32.  TMA im2col: Inception-v3's non-square filters with
    # asymmetric padding (C = 128, 192, 384), AlexNet's 5x5, Inception's
    # unpadded stride-2 3x3 (Mixed_7a), DenseNet's 3x3 with O = 32
    'inc_1x7_c128': ((32, 128, 17, 17), 128, (1, 7), 1, (0, 3), 1, False),
    'inc_7x1_c192': ((32, 192, 17, 17), 192, (7, 1), 1, (3, 0), 1, False),
    'inc_1x3_c384': ((32, 384, 8, 8), 384, (1, 3), 1, (0, 1), 1, False),
    'inc_3x1_c384': ((32, 384, 8, 8), 384, (3, 1), 1, (1, 0), 1, False),
    'alex_5x5_c64': ((32, 64, 27, 27), 192, 5, 1, 2, 1, False),
    'inc_3x3_s2_c192_nopad': ((32, 192, 17, 17), 192, 3, 2, 0, 1, False),
    'dense_3x3_o32': ((32, 128, 56, 56), 32, 3, 1, 1, 1, False),
    # the implicit GEMM: C no multiple of 64 (Inception's 5x5 at C = 48 and
    # Mixed_6a at C = 288, GoogLeNet's 3x3 at C = 16 and 96, SqueezeNet's
    # expand3x3 at C = 16), ShuffleNet's grouped 1x1 (groups 8, Cg = 96 and 12)
    'inc_5x5_c48': ((32, 48, 35, 35), 64, 5, 1, 2, 1, False),
    'inc_3x3_s2_c288': ((32, 288, 35, 35), 384, 3, 2, 0, 1, False),
    'goog_3x3_c16': ((32, 16, 28, 28), 32, 3, 1, 1, 1, False),
    'goog_3x3_c96': ((32, 96, 28, 28), 128, 3, 1, 1, 1, False),
    'sq_3x3_c16': ((32, 16, 54, 54), 64, 3, 1, 1, 1, False),
    'shuf_g8_1x1_c768': ((32, 768, 14, 14), 192, 1, 1, 0, 8, True),
    'shuf_g8_1x1_c96_o360': ((32, 96, 28, 28), 360, 1, 1, 0, 8, True),
    # the direct depthwise route: ShuffleNet's 3x3, stride 1 and 2
    'shuf_dw_s1_c96': ((32, 96, 28, 28), 96, 3, 1, 1, 96, True),
    'shuf_dw_s2_c192': ((32, 192, 28, 28), 192, 3, 2, 1, 192, True),
}
# the two serving shapes, the bench's int8-rate probe and VGG's first
# classifier at batch 32
TIMED_GEMMS = ((200704, 256, 64), (3136, 512, 2048), (4096, 16384, 4096), (32, 25088, 4096))
# the two heaviest ResNet-50 serving shapes of the epilogue features: layer1's
# conv1 GEMM at batch 64 and its 3x3 conv2 at batch 128 ([N, C, H, W], O)
CODES_TIMED_GEMM = (200704, 256, 64)
CODES_TIMED_CONV = ((128, 64, 56, 56), 64)
# the float hand-off's largest entry tensors at the serving cells' batches
# (name, NCHW shape, one scale a channel): Inception-v3's Conv2d_2a input at
# 299x299, MobileNet-v2's widest depthwise input, ResNet-50's stem output
CODES_TIMED = (('inception_v3.Conv2d_2a_3x3', (128, 32, 149, 149), False),
               ('mobilenet_v2.depthwise_c96', (128, 96, 112, 112), True),
               ('resnet50.stem_b256', (256, 64, 112, 112), False))
TIMED_CONVS = ('3x3_s1_c64', '3x3_s1_c512', '3x3_s1_c128_b128', '3x3_s1_c256_b128',
               '3x3_s1_c512_b128', '1x1_s2_c256', 'dw_s1_c144_b128', 'dw_s2_c96_b128',
               'inc_1x7_c128', 'shuf_g8_1x1_c768')
REPLACES_INT4 = 'cnn_quantization_tpu/ops/kernels/int4_matmul.py:229'
# the packed path's int4 GEMM calls at 224x224, batch 64: name -> (M, K, N, A
# packed, residual, ReLU, out_mode); M = batch * H * W.  'rows' slices the rows
# of a [64, K/2, 56, 56] packed activation spatially by 2, as a strided 1x1
# conv does ahead of the GEMM.
INT4_CASES = {
    's1_b0_conv1': (200704, 64, 64, False, False, True, 'int8'),
    's1_downsample': (200704, 64, 256, False, False, False, 'packed'),
    's1_conv3': (200704, 64, 256, False, True, True, 'packed'),
    's1_conv1': (200704, 256, 64, True, False, True, 'int8'),
    's2_downsample_rows': (50176, 256, 512, True, False, False, 'packed'),
    's4_conv1': (3136, 2048, 512, True, False, True, 'int8'),
    's4_conv3_to_plain': (3136, 512, 2048, False, True, True, 'int8'),
    's4_last_f32': (3136, 512, 2048, False, True, True, 'f32'),
    's4_last_bf16': (3136, 512, 2048, False, True, True, 'bf16'),
    'ragged_13': (13, 256, 256, True, True, True, 'packed'),
    'ragged_70_f32': (70, 64, 256, False, True, False, 'f32'),
    'ragged_70_n64': (70, 512, 64, True, False, True, 'int8'),
    # K = 40, no multiple of 16: the mma.sync route by the route rule
    'ragged_k40': (70, 40, 256, False, True, True, 'packed'),
}
TIMED_INT4 = ('s1_conv3', 's1_conv1', 's4_conv1', 's4_last_f32')
REPLACES_COPY = 'bench.py:315'
PROBE_SHAPE = (128 * 56 * 56, 256)   # the memory-rate probe's int8 tensor, 102.76 MB
# stream-copy cases: the probe's own shape, a ragged M, a C that is no multiple of 16
COPY_SHAPES = (PROBE_SHAPE, (1001, 256), (4097, 250), (7, 3))
BENCH_BATCH = 128


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


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

    mark = counters.snapshot()
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
    launches = launched_since(mark)['fake_quant']

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
    the plain version, deterministic cuDNN: argmax equal, logits within 1e-3;
    frozen (``qparams``, ``stats``) and dynamic, or dynamic alone without
    ``qparams``."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    runs = (('frozen', dict(qparams=qparams), stats), ('dynamic', {}, None))
    for name, kw, st in runs[qparams is None:]:
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


def pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_case(name, qmax, gen, device):
    """A conv of the serving path: int8 codes in channels_last memory, OIHW
    codes with their scales, a scalar or per-group activation scale."""
    shape, o, k, s, p, groups, vector = CONV_SHAPES[name]
    cl = torch.channels_last
    x = int8_codes(shape, qmax, gen, device).contiguous(memory_format=cl)
    w = int8_codes((o, shape[1] // groups, *pair(k)), qmax, gen,
                   device).contiguous(memory_format=cl)
    w_scale = (torch.rand(o, generator=gen) * 1e-2 + 1e-3).to(device)
    bias = torch.randn(o, generator=gen).to(device)
    if vector:
        gs = torch.rand(groups, generator=gen) * 0.1 + 0.01
        act_scale = gs.repeat_interleave(shape[1] // groups).to(device)
    else:
        act_scale = torch.full((), 0.05, device=device)
    return (x, w, w_scale, bias), dict(strides=pair(s), padding=pair(p), groups=groups,
                                       act_scale=act_scale)


def bf16_over_one_ulp(got, want):
    """Elements further from the plain version than one bf16 ulp (2^-7
    relative: bf16 keeps 8 significant bits)."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > want.abs() * 2.0 ** -7 + 1e-30).sum())


ROUTES = {   # route_launches' key: its counter in utils/counters
    'wgmma': 'int8_gemm.wgmma', 'mma_sync': 'int8_gemm.mma_sync',
    'depthwise': 'int8_conv.depthwise', 'im2col_wgmma': 'int8_conv.im2col_wgmma',
    'implicit_gemm': 'int8_conv.implicit_gemm',
    'int4_wgmma': 'int4_gemm.wgmma', 'int4_mma_sync': 'int4_gemm.mma_sync',
}


def route_launches(mark):
    """Launches by route since the store's snapshot ``mark``: the int8 GEMM's
    TMA + wgmma and mma.sync kernels, the int8 conv's direct depthwise, TMA
    im2col + wgmma and implicit-GEMM kernels, the int4 GEMM's TMA + wgmma and
    mma.sync kernels."""
    moved = counters.since(mark)
    return Counter({key: moved.get(name, 0) for key, name in ROUTES.items()})


def launched_since(mark):
    """Launches of each of the five kernels since the store's snapshot
    ``mark``."""
    return Counter(counters.by_kernel(counters.since(mark)))


def kernel_launches(mark):
    """(int4 GEMM, int8 GEMM, int8 conv) launches since ``mark``."""
    k = launched_since(mark)
    return k['int4_gemm'], k['int8_gemm'], k['int8_conv']


@contextlib.contextmanager
def device_kernels(ran: Counter):
    """Adds to ``ran`` the kernels the device ran inside the block, by class,
    as torch.profiler traced them: launched one by one or replayed from a
    CUDA graph, whose replays run no wrapper that the counters see.  Classes
    are ``utils/profiling.kernel_class``'s, the float hand-off's codes
    kernel is ``'quantize_codes'``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield ran
        torch.cuda.synchronize()
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).rsplit('.', 1)[-1] != 'CUDA':
            continue
        name = e.name()
        ran['quantize_codes' if 'quantize_codes_elementwise_kernel' in name
            else kernel_class(name)] += 1


def int8_kernels_vs_plain(device):
    """Both int8 kernels, each by both of its routes, against their plain
    versions at the serving path's shapes, on both code grids.  The int32 sums
    are exact and the epilogue rounds each operation as the plain version
    does, so float32 outputs must be bit-identical; bf16 within one bf16 ulp."""
    gen = torch.Generator().manual_seed(1)
    gemm_err, conv_err, bf16_over = {}, {}, 0
    routes = {}
    mark = counters.snapshot()
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
                        routes[key] = im.gemm_route(k)
                        err = float((got - want).abs().max())
                        gemm_err[key] = max(gemm_err.get(key, 0.0), err)
                    else:
                        bf16_over += bf16_over_one_ulp(got, want)
    for name in CONV_SHAPES:
        shape, o, k, s, p, groups, _ = CONV_SHAPES[name]
        routes[name] = ic.conv_route(shape[1], o, groups, kernel=pair(k), strides=pair(s),
                                     padding=pair(p))
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
    launched = +route_launches(mark)
    emit('int8_kernels_vs_plain', gemm_max_abs_err_fp32=gemm_err,
         conv_max_abs_err_fp32=conv_err, bf16_elements_over_one_ulp=bf16_over, routes=routes,
         route_launches=launched)
    check(all(launched[r] > 0 for r in ('wgmma', 'mma_sync', 'depthwise', 'im2col_wgmma',
                                        'implicit_gemm')),
          f'a route of the int8 kernels was not held to its plain version: {launched}')
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


def serving_launches(model, stages=(), s2d_stem=False):
    """(kernel, route) of every integer launch of one serving forward, from
    the model's modules and the routing rules: a 1x1 stride-1 unpadded
    ungrouped conv and every linear is an int8 GEMM (routed by
    ``int_matmul.gemm_route`` from its K), every other conv goes to the conv
    kernel (routed by ``int_conv.conv_route``), and the in_ch == 3 stem stays a
    float conv unless it was space-to-depth transformed (12 channels, 4x4).  In
    the 1-based ``stages`` that run packed, conv1, conv3 and the downsample conv
    of every block are int4 GEMMs (routed by ``int4_matmul.int4_route``; conv1
    and the downsample take packed codes except in stage 1 block 0)."""
    for name, m in model.named_modules():
        if isinstance(m, QLinear):
            yield 'int8_gemm', im.gemm_route(m.weight.shape[1])
        elif isinstance(m, QConv):
            stage = int(name[5]) if name.startswith('layer') else 0
            if m.in_ch == 3:
                if s2d_stem:
                    yield 'int8_conv', ic.conv_route(12, m.features, 1, kernel=(4, 4))
            elif stage in stages and name.endswith(('.conv1', '.conv3', '.downsample.0')):
                a_packed = not name.startswith('layer1.0.') and not name.endswith('.conv3')
                yield 'int4_gemm', 'int4_' + i4.int4_route(m.in_ch, a_packed)
            elif (tuple(m.weight.shape[2:]), m.strides, m.padding, m.groups) \
                    == ((1, 1), (1, 1), (0, 0), 1):
                yield 'int8_gemm', im.gemm_route(m.in_ch)
            else:
                yield 'int8_conv', ic.conv_route(m.in_ch, m.features, m.groups,
                                                 kernel=tuple(m.weight.shape[2:]),
                                                 strides=m.strides, padding=m.padding)


def launch_table(model, stages=(), s2d_stem=False):
    """(int4 GEMM, int8 GEMM, int8 conv) launches of one serving forward."""
    kinds = Counter(kind for kind, _ in serving_launches(model, stages, s2d_stem))
    return kinds['int4_gemm'], kinds['int8_gemm'], kinds['int8_conv']


def route_table(model, stages=(), s2d_stem=False):
    """Launches by route of one serving forward (``route_launches``' keys)."""
    return Counter(route for _, route in serving_launches(model, stages, s2d_stem) if route)


def times(table, n):
    return Counter({k: v * n for k, v in table.items()})


def drive_serving_path(device, *, arch='resnet50', size=224, batch=64, eval_batches=4):
    """The true-int8 serving path through the entry points a user calls:
    weight pass, serving preparation, scale freeze (max, 2 batches), frozen
    evaluation; then one forward each with ACIQ-calibrated scales, on the
    W4A4 grid, with the space-to-depth stem and with dynamic scales.  Returns
    (engine, prepared params, frozen scales, weight-quantized params, one
    batch, report).  The report's ``*_launches`` are the kernels the device
    ran (traced), ``*_counted`` and ``route_counted`` what the counter store
    counted, where a graph's replay adds what its capture counted."""
    model, meta = build_model(arch, device=device, seed=0)
    params = dict(model.state_dict())
    batches = list(synthetic_batches(batch, eval_batches, size=size, seed=12345))
    images = batches[0][0]
    _, gemm_per, conv_per = launch_table(model)
    _, _, conv_s2d = launch_table(model, s2d_stem=True)
    # a frozen forward's float hand-offs: the stem output at the first block's
    # scale and the classifier's input; the blocks pass codes
    codes_per = 1 + sum(isinstance(m, QLinear) for m in model.modules())
    routes_per, routes_s2d = route_table(model), route_table(model, s2d_stem=True)

    def serve(eng, sp, scales):
        logits, aux = eng.make_forward(quantized='serving_int8', act_scales=scales)(
            sp, None, images)
        return bool(torch.isfinite(logits).all()) and logits.shape == (batch, 1000), aux

    # the device's kernels are traced (``device_kernels``): a frozen forward
    # replays a CUDA graph, which runs no wrapper, so the store only adds
    # back what the capture counted
    ran, ran_eval = Counter(), Counter()
    mark = counters.snapshot()
    t0 = time.perf_counter()
    with device_kernels(ran):
        eng = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta)
        pq = eng.quantize_params(params)
        sp = eng.prepare_serving_params(pq)
        scales = eng.freeze_serving_scales(sp, batches, max_batches=2, mode='max')
    codes_mark = counters.snapshot()
    with device_kernels(ran_eval):
        res = evaluate(eng, sp, batches, quantized='serving_int8', act_scales=scales)
    eval_counted = counters.since(codes_mark)
    with device_kernels(ran):
        finite = {}
        aciq = eng.freeze_serving_scales(sp, batches, max_batches=2, mode='aciq')
        finite['aciq'], _ = serve(eng, sp, aciq)
        eng4 = QuantEngine(model, QuantPolicy(arch=arch, **W4A4), meta)
        sp4 = eng4.prepare_serving_params(eng4.quantize_params(params))
        finite['w4a4'], _ = serve(eng4, sp4,
                                  eng4.freeze_serving_scales(sp4, batches, max_batches=2))
        sp_s2d = eng.prepare_serving_params(pq, s2d_stem=True)
        scales_s2d = eng.freeze_serving_scales(sp_s2d, batches, max_batches=2)
        finite['s2d_stem'], _ = serve(eng, sp_s2d, scales_s2d)
        finite['dynamic'], recorded = serve(eng, sp, None)
    wall = time.perf_counter() - t0
    ran += ran_eval
    _, gemm_counted, conv_counted = kernel_launches(mark)
    routes, graph = route_launches(mark), counters.since(mark)

    # 2 calibration forwards per freeze; the s2d stem adds one conv launch
    forwards = (2 + eval_batches) + (2 + 1) + (2 + 1) + 1
    forwards_s2d = 2 + 1
    # each frozen forward captures its graph at its first call (the
    # evaluation's, ACIQ's, W4A4's; the s2d stem's): a forward run module by
    # module on a side stream, then the capture, which runs nothing; the store
    # counts that call as the one forward its first replay runs
    warmups, warmups_s2d = 3, 1
    predicted_gemm = gemm_per * (forwards + forwards_s2d)
    predicted_conv = conv_per * forwards + conv_s2d * forwards_s2d
    predicted_routes = times(routes_per, forwards) + times(routes_s2d, forwards_s2d)
    s2d_codes = sp_s2d['conv1.weight']
    report = dict(arch=arch, input_size=size, batch=batch, grid='W8A8',
                  gemm_per_forward=gemm_per, conv_per_forward=conv_per,
                  conv_per_forward_s2d_stem=conv_s2d, forwards=forwards + forwards_s2d,
                  graph_captures=graph.get('serving_graph.captures', 0),
                  predicted_graph_captures=warmups + warmups_s2d,
                  graph_replays=graph.get('serving_graph.replays', 0),
                  predicted_graph_replays=eval_batches - 1,
                  gemm_launches=ran['int8_gemm'],
                  predicted_gemm_launches=gemm_per * (forwards + forwards_s2d + warmups
                                                      + warmups_s2d),
                  conv_launches=ran['int8_conv'],
                  predicted_conv_launches=(conv_per * (forwards + warmups)
                                           + conv_s2d * (forwards_s2d + warmups_s2d)),
                  gemm_counted=gemm_counted, predicted_gemm_counted=predicted_gemm,
                  conv_counted=conv_counted, predicted_conv_counted=predicted_conv,
                  routes_per_forward=routes_per, route_counted=routes,
                  predicted_route_counted=predicted_routes,
                  codes_per_forward=codes_per, codes_launches=ran_eval['quantize_codes'],
                  predicted_codes_launches=codes_per * (eval_batches + 1),
                  codes_counted=eval_counted.get('quantize_codes.launches', 0),
                  predicted_codes_counted=codes_per * eval_batches,
                  frozen_sites=len(scales), frozen_sites_s2d_stem=len(scales_s2d),
                  dynamic_recorded_sites=len(recorded),
                  s2d_stem_kernel=[str(s2d_codes.dtype), list(s2d_codes.shape)],
                  w4a4_max_code=int(sp4['layer1.0.conv1.weight'].abs().max()),
                  top1=res['top1'], top5=res['top5'], loss=res['loss'],
                  images_per_sec=res['images_per_sec'], finite=finite,
                  serving_path_wall_s=wall)
    return eng, sp, scales, pq, images, report


def check_serving_path(srep):
    """``main``'s checks of ``drive_serving_path``'s report."""
    for what in ('gemm', 'conv', 'codes'):
        check(srep[f'{what}_launches'] > 0
              and srep[f'{what}_launches'] == srep[f'predicted_{what}_launches'],
              f"serving path: the device ran {srep[f'{what}_launches']} {what} kernels, "
              f"predicted {srep[f'predicted_{what}_launches']}")
        check(srep[f'{what}_counted'] == srep[f'predicted_{what}_counted'],
              f"serving path: {srep[f'{what}_counted']} {what} launches counted, predicted "
              f"{srep[f'predicted_{what}_counted']}")
    check(srep['graph_captures'] == srep['predicted_graph_captures']
          and srep['graph_replays'] == srep['predicted_graph_replays'],
          f"serving path graphs: {srep['graph_captures']} captures, {srep['graph_replays']} "
          f"replays")
    check(np.isfinite([srep['top1'], srep['top5'], srep['loss']]).all()
          and all(srep['finite'].values()), f"non-finite serving output: {srep['finite']}")
    check(srep['routes_per_forward'] == Counter(wgmma=34, im2col_wgmma=19)
          and srep['route_counted'] == srep['predicted_route_counted'],
          f"serving routes counted {srep['route_counted']}, the route table predicts "
          f"{srep['predicted_route_counted']}")
    check(srep['dynamic_recorded_sites'] == srep['gemm_per_forward'] + srep['conv_per_forward']
          and srep['frozen_sites_s2d_stem'] == srep['frozen_sites'] + 1
          and srep['s2d_stem_kernel'] == ['torch.int8', [64, 12, 4, 4]]
          and srep['w4a4_max_code'] == 7, f'serving path bookkeeping: {srep}')


def int8_resident_flow(eng, sp, scales, pq, images):
    """With frozen scales the block input is quantized once: every block's
    conv1 and downsample conv receive a QTensor, the max-pool runs on codes.
    Also the relative error of the frozen logits to the float logits of the
    same weights (reported; bounded at resnet18 64x64 in serving_card_vs_cpu)."""
    # the forward run module by module: a replayed graph runs no module to watch
    fwd, result = eng.make_forward(quantized='serving_int8', act_scales=scales).eager, []
    seen = bench.module_inputs(eng.model, lambda: result.append(fwd(sp, None, images)))
    (logits, aux), = result
    got_codes = {m.site.id: kind == 'codes' for m, kind, _, _ in seen if isinstance(m, QConv)}
    pool_on_codes = [kind == 'codes' and dtype == torch.int8 for m, kind, dtype, _ in seen
                     if isinstance(m, QMaxPool)]
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


def kernels_vs_plain_end_to_end(phase, eng, sp, scales, images, packed=False, tol=1e-6):
    """The same prepared params, scales and batch through a serving forward
    with the kernels and with all three integer wrappers patched to their
    plain versions.  The integer part is exact and the float stem is the same
    cuDNN call in both (deterministic algorithms), so: relative error <=
    ``tol`` (1e-6 for float32 activations), argmax equal."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    fwd = eng.make_forward(quantized='serving_int8', act_scales=scales, packed=packed)
    kern, _ = fwd(sp, None, images)
    mark = counters.snapshot()
    # the plain side runs module by module: a replayed graph calls no wrapper
    with mock.patch.object(i4, 'int4_matmul', i4.int4_matmul_plain), \
            mock.patch.object(im, 'int8_matmul_dequant', im.int8_matmul_dequant_plain), \
            mock.patch.object(ic, 'int8_conv_dequant', ic.int8_conv_dequant_plain):
        plain, _ = fwd.eager(sp, None, images)
    out = dict(rel_err=rel_err(kern, plain),
               plain_run_launched_no_kernel=not any(kernel_launches(mark)),
               argmax_equal=bool(torch.equal(kern.argmax(-1), plain.argmax(-1))))
    emit(phase, **out)
    check(out['argmax_equal'] and out['rel_err'] <= tol and out['plain_run_launched_no_kernel'],
          f'{phase}: {out}')
    return out


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


def int8_bound_ms(ops, nbytes):
    """The least time for an int8 product: its operations at the tensor
    cores' dense int8 rate, or its bytes (each input read once, each output
    written once) at the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def int8_timing(device, card):
    """Each int8 kernel at its heaviest shapes on the serving path (and the
    GEMM at the bench's int8-rate probe): kernel, plain version, bound, the
    route taken, and one library call where one computes the same product
    (the port never calls either): for the GEMM torch._int_mm (the int32
    product only, no epilogue); for a conv whose sums stay below 2^24 (exact
    in float32: the depthwise and the C = 64 shapes) F.conv2d on float32 codes
    with TF32 off (the product alone, at 4-byte input), for the others
    torch._int_mm on the explicit im2col matrix (the product only, the im2col
    excluded).  A conv on the im2col route is timed on the implicit GEMM as
    well (``old_route_ms``; both outputs must be equal).  No cache flush
    between launches: the largest shapes exceed the 50 MB L2, the late-stage
    ones fit and are found warm, as their producer leaves them on the path."""
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
            plain_ms=plain_ms, route=im.gemm_route(k),
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            tera_ops_per_s=ops / ms / 1e9, library_tera_ops_per_s=ops / library_ms / 1e9,
            gb_per_s=nbytes / ms / 1e6))
    for name in TIMED_CONVS:
        (x, w, w_scale, bias), kw = conv_case(name, 127, gen, device)
        act = kw.pop('act_scale')
        if act.ndim == 1:
            # per-group input scales to the output channels, as int8_conv maps them
            act = act.view(kw['groups'], -1)[:, 0].repeat_interleave(w.shape[0] // kw['groups'])
        alpha = act * w_scale
        ms = cuda_ms(lambda: ic.int8_conv_dequant(x, w, alpha, bias, **kw))
        host_paced_ms = cuda_ms(lambda: ic.int8_conv_dequant(x, w, alpha, bias, **kw),
                                head_start=False)
        plain_ms = cuda_ms(lambda: ic.int8_conv_dequant_plain(x, w, alpha, bias, **kw), iters=5,
                           warmup=1)
        out = ic.int8_conv_dequant(x, w, alpha, bias, **kw)
        route = ic.conv_route(x.shape[1], w.shape[0], kw['groups'], kernel=tuple(w.shape[2:]),
                              strides=kw['strides'], padding=kw['padding'])
        old_route_ms = None
        if route == 'im2col_wgmma':
            def old():
                return ic.launch(x, w, alpha, bias, kw['strides'], kw['padding'], kw['groups'],
                                 False, torch.float32, route='implicit_gemm')
            check(torch.equal(old(), out), f'{name}: implicit GEMM != im2col route')
            old_route_ms = cuda_ms(old)
        library_ms, library = None, None
        if w[0].numel() * 127 * 127 < 2 ** 24:
            xf, wf = x.float(), w.float()
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                library_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
                    xf, wf, None, kw['strides'], kw['padding'], groups=kw['groups']))
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            del xf, wf
            library = 'F.conv2d on float32 codes, TF32 off'
        elif kw['groups'] == 1:
            patches, _ = ic._extract_patches(x, w.shape[2], w.shape[3], kw['strides'],
                                             kw['padding'])
            w2 = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
            library_ms = cuda_ms(lambda: torch._int_mm(patches, w2.t()))
            library = 'torch._int_mm on the im2col matrix: product only, im2col excluded'
            del patches
        ops = 2 * out.numel() * w[0].numel()
        nbytes = x.numel() + w.numel() + 4 * out.numel() + 8 * w.shape[0]
        bound_ms, bound_by = int8_bound_ms(ops, nbytes)
        rows['int8_conv'].append(dict(
            shape=f'{list(x.shape)} * {list(w.shape)} stride {kw["strides"][0]} padding '
                  f'{list(kw["padding"])} groups {kw["groups"]}', out='float32',
            ms=ms, host_paced_ms=host_paced_ms, plain_ms=plain_ms, library_ms=library_ms,
            library=library, route=route, old_route_ms=old_route_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            tera_ops_per_s=ops / ms / 1e9, gb_per_s=nbytes / ms / 1e6))
    emit('int8_timing', card=card, **rows)
    return rows


def codes_epilogue_timing(device, card):
    """The int8 kernels' epilogue features at ``CODES_TIMED_GEMM`` and
    ``CODES_TIMED_CONV``: float32 out and int8 codes out (one frozen scale),
    each without and with a residual in (int8 codes in the output's layout),
    ReLU on, each held equal to its plain version before it is timed.  Bound:
    the operations, or the bytes (the codes in, the weights, alpha and beta,
    the residual, the output at 4 or 1 bytes) at the memory rate."""
    gen = torch.Generator().manual_seed(6)
    out_scale = torch.full((), 0.05, device=device)
    m, k, n = CODES_TIMED_GEMM
    a, b, alpha, beta = gemm_case(m, k, n, 127, gen, device)
    cases = [(f'[{m},{k}]x[{k},{n}]', 'wgmma', (m, n), 2 * m * n * k, m * k + k * n + 8 * n,
              lambda **f: im.int8_matmul_dequant(a, b, alpha, beta, fuse_relu=True, **f),
              lambda **f: im.int8_matmul_dequant_plain(a, b, alpha, beta, fuse_relu=True, **f))]
    shape, o = CODES_TIMED_CONV
    (x, w, w_scale, bias), _ = conv_case('3x3_s1_c64', 127, gen, device)
    x = int8_codes(shape, 127, gen, device).contiguous(memory_format=torch.channels_last)
    calpha = w_scale * 0.05
    kw = dict(strides=(1, 1), padding=(1, 1))
    cases.append((f'{list(shape)} * {list(w.shape)} stride 1 padding [1, 1]', 'im2col_wgmma',
                  (shape[0], o, shape[2], shape[3]), 2 * x.numel() * o * 9,
                  x.numel() + w.numel() + 8 * o,
                  lambda **f: ic.int8_conv_dequant(x, w, calpha, bias, fuse_relu=True, **kw, **f),
                  lambda **f: ic.int8_conv_dequant_plain(x, w, calpha, bias, fuse_relu=True, **kw,
                                                         **f)))
    rows = []
    for name, route, out_shape, ops, in_bytes, kernel, plain in cases:
        res = (int8_codes(out_shape, 127, gen, device), torch.full((), 0.03, device=device))
        if len(out_shape) == 4:
            res = (res[0].contiguous(memory_format=torch.channels_last), res[1])
        outs = int(np.prod(out_shape))
        for codes in (False, True):
            for with_res in (False, True):
                f = dict(out_scale=out_scale if codes else None,
                         residual=res if with_res else None)
                check(torch.equal(kernel(**f), plain(**f)),
                      f'{name} codes={codes} residual={with_res}: kernel != plain')
                ms = cuda_ms(lambda: kernel(**f))
                nbytes = in_bytes + outs * (1 if codes else 4) + (outs if with_res else 0)
                bound_ms, bound_by = int8_bound_ms(ops, nbytes)
                rows.append(dict(shape=name, route=route, out='int8' if codes else 'float32',
                                 residual=with_res, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                                 x_bound=ms / bound_ms, gb_per_s=nbytes / ms / 1e6))
    emit('codes_epilogue_timing', card=card, rows=rows)
    return rows


def quantize_codes_timing(device, card):
    """The float hand-off's codes kernel at ``CODES_TIMED``: float32 in
    channels_last memory, as the convs hand it on, one scale or one a channel,
    held equal to the plain composition (divide, round, clamp, cast) and then
    timed beside it.  Bound: each float read once and each code written once
    at the memory rate; the tensors exceed the 50 MB L2."""
    gen = torch.Generator(device=device).manual_seed(9)
    rows = []
    for name, shape, per_channel in CODES_TIMED:
        x = torch.randn(shape, generator=gen, device=device).contiguous(
            memory_format=torch.channels_last)
        scale = ((torch.rand(shape[1], generator=gen, device=device) * 0.02 + 0.01)
                 .view(1, -1, 1, 1) if per_channel else torch.full((), 0.0137, device=device))
        check(torch.equal(im.quantize_sym_codes(x, scale), im.quantize_sym_codes_plain(x, scale)),
              f'{name}: codes kernel != plain')
        ms = cuda_ms(lambda: im.quantize_sym_codes(x, scale))
        plain_ms = cuda_ms(lambda: im.quantize_sym_codes_plain(x, scale), iters=10)
        nbytes = 5 * x.numel() + 4 * scale.numel()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(name=name, shape=list(shape), per_channel=per_channel, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
                         gb_per_s=nbytes / ms / 1e6))
        del x
    emit('quantize_codes_timing', card=card, rows=rows)
    return rows


def codes_row(srep, rows):
    """The ``kernels`` line's row of the float hand-off's codes kernel: the
    runs the device traced in the serving path's frozen evaluation (its four
    forwards and the forward run beside its graph's capture; a CUDA call
    launches the kernel or raises), and ``quantize_codes_timing``'s first
    shape.
    Held to the plain composition bit for bit, so no error."""
    t = rows[0]
    return {'name': 'quantize_codes', 'route': 'cuda',
            'source': 'cnn_quantization_tpu_torch/csrc/fake_quant.cu', 'replaces': REPLACES_CODES,
            'shape': t['shape'], 'launches': srep['codes_launches'],
            'predicted_launches': srep['predicted_codes_launches'], 'max_abs_err': 0,
            'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': 'bytes', 'share_of_bound': t['share_of_bound']}


def int4_case(name, gen, device):
    """One int4 GEMM call of the packed path on the +-7 grid: (a, b, alpha,
    beta) and the keyword arguments, scales as device scalars."""
    m, k, n, a_packed, with_res, relu, mode = INT4_CASES[name]
    if name.endswith('_rows'):
        full = i4.pack_int4(int8_codes((64, 56, 56, k), 7, gen, device))   # NHWC bytes
        a = full[:, ::2, ::2, :].reshape(m, k // 2)
    else:
        a = int8_codes((m, k), 7, gen, device)
        a = i4.pack_int4(a) if a_packed else a
    bt = int8_codes((n, k), 7, gen, device)
    alpha = (torch.rand(n, generator=gen) * 2e-3 + 1e-4).to(device)
    beta = (torch.randn(n, generator=gen) * 0.05).to(device)
    kw = dict(a_packed=a_packed, fuse_relu=relu, out_mode=mode, out_qmax=7.0,
              out_scale=torch.full((), 0.07, device=device))
    if with_res:
        kw.update(residual=i4.pack_int4(int8_codes((m, n), 7, gen, device)),
                  res_scale=torch.full((), 0.11, device=device))
    return (a, bt.t(), alpha, beta), kw


def int4_launch(args, kw, route):
    """One int4 GEMM launch on ``route`` ('wgmma' where the call takes it, or
    'mma_sync', which takes every call)."""
    a, b, alpha, beta = args
    return i4.launch(a, b, alpha, beta, kw.get('residual'), kw.get('res_scale'),
                     kw.get('out_scale'), kw['a_packed'], kw['fuse_relu'], kw['out_mode'],
                     kw['out_qmax'], kw.get('out_dtype', torch.float32), route=route)


def int4_kernel_vs_plain(device):
    """The int4 GEMM kernel against its plain version in every mode the packed
    path uses, at the path's own shapes, plus ragged M and a K that is no
    multiple of 16, each call by its route and by the mma.sync route: codes
    and packed bytes must be equal, float32 outputs bit-identical, bf16 within
    one ulp; and the pack/unpack round trip on the card."""
    gen = torch.Generator().manual_seed(3)
    errs, bf16_over, routes = {}, 0, {}
    mark = counters.snapshot()
    for name in INT4_CASES:
        args, kw = int4_case(name, gen, device)
        want = i4.int4_matmul_plain(*args, **kw)
        routes[name] = i4.int4_route(INT4_CASES[name][1], kw['a_packed'])
        for route in (None, 'mma_sync'):
            got = i4.int4_matmul(*args, **kw) if route is None else int4_launch(args, kw, route)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f'int4 {name}: shape or dtype')
            if kw['out_mode'] == 'bf16':
                bf16_over += bf16_over_one_ulp(got, want)
                continue
            # integer outputs compared as bytes; |difference| of codes for the report
            err = float((got.float() - want.float()).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
            check(torch.equal(got, want),
                  f'int4 GEMM != plain in {name} ({route or routes[name]}): max abs {err}')
    launched = +route_launches(mark)
    codes = int8_codes((4096, 512), 7, gen, device)
    raw = torch.randint(-128, 128, (4096, 256), generator=gen, dtype=torch.int8).to(device)
    round_trip = bool(torch.equal(i4.unpack_int4(i4.pack_int4(codes)), codes)
                      and torch.equal(i4.pack_int4(i4.unpack_int4(raw)), raw))
    emit('int4_kernel_vs_plain', max_abs_err=errs, bf16_elements_over_one_ulp=bf16_over,
         routes=routes, route_launches=launched, pack_unpack_round_trip=round_trip)
    check(launched['int4_wgmma'] > 0 and launched['int4_mma_sync'] > 0
          and routes['ragged_k40'] == 'mma_sync',
          f'a route of the int4 GEMM was not held to its plain version: {launched}')
    check(bf16_over == 0, f'{bf16_over} int4 GEMM bf16 outputs off by more than one ulp')
    check(round_trip, 'pack_int4/unpack_int4 round trip on the card')
    return max(errs.values())


def im2col_vs_implicit(device):
    """im2col patches + the int8 GEMM kernel against the implicit-GEMM conv
    kernel at 3x3_s1_c64: the same function, bit for bit."""
    gen = torch.Generator().manual_seed(4)
    (x, w, w_scale, bias), kw = conv_case('3x3_s1_c64', 7, gen, device)
    kw.pop('groups')
    mark = counters.snapshot()
    explicit = ic.int8_conv_im2col(x, w, w_scale, bias, fuse_relu=True, **kw)
    implicit = ic.int8_conv(x, w, w_scale, bias, fuse_relu=True, **kw)
    torch.cuda.synchronize()
    through = kernel_launches(mark)[1:]
    equal = bool(torch.equal(explicit, implicit))
    emit('im2col_vs_implicit_conv', shape='3x3_s1_c64', equal=equal,
         gemm_and_conv_launches=list(through))
    check(equal and through == (1, 1), 'im2col + int8 GEMM != implicit-GEMM int8 conv')


def drive_packed_path(device, *, arch='resnet50', size=224, batch=64, eval_batches=4):
    """The W4A4 packed serving path through the entry points a user calls:
    weight pass, serving preparation, scale freeze with the packed grid (max,
    2 batches), frozen packed evaluation; then one forward each with stages
    (1,) and (2, 3) packed, and one with the ``:out:packed`` keys removed,
    which must fall back to the plain path in full.  Returns (engine, prepared
    params, frozen scales, one batch, report); its ``launches`` are the
    kernels the device ran (traced), ``counted`` what the counter store
    counted (drive_serving_path)."""
    model, meta = build_model(arch, device=device, seed=0)
    params = dict(model.state_dict())
    batches = list(synthetic_batches(batch, eval_batches, size=size, seed=12345))
    images = batches[0][0]
    all_stages = (1, 2, 3, 4)
    table = {st: launch_table(model, st) for st in ((), (1,), (2, 3), all_stages)}
    routes = {st: route_table(model, st) for st in table}

    def forward(scales, packed):
        logits, _ = eng.make_forward(quantized='serving_int8', act_scales=scales,
                                     packed=packed)(sp, None, images)
        return logits

    # the device's kernels are traced (``device_kernels``), as in
    # drive_serving_path; per_forward_counted is what the counter store
    # counted, which a replay copies from its capture
    ran = Counter()
    mark = counters.snapshot()
    t0 = time.perf_counter()
    with device_kernels(ran):
        eng = QuantEngine(model, QuantPolicy(arch=arch, **W4A4), meta)
        sp = eng.prepare_serving_params(eng.quantize_params(params))
        scales = eng.freeze_serving_scales(sp, batches, max_batches=2, mode='max', packed=True)
        after_freeze = kernel_launches(mark)
        res = evaluate(eng, sp, batches, quantized='serving_int8', act_scales=scales,
                       packed=True)
        after_eval = kernel_launches(mark)
        finite, per_forward = {}, {}
        for name, packed in (('stage_1', (1,)), ('stages_2_3', (2, 3))):
            before = kernel_launches(mark)
            logits = forward(scales, packed)
            finite[name] = bool(torch.isfinite(logits).all()) and logits.shape == (batch, 1000)
            per_forward[name] = [b - a for a, b in zip(before, kernel_launches(mark))]
        no_packed_keys = {k: v for k, v in scales.items() if not k.endswith(':out:packed')}
        before = kernel_launches(mark)
        fallback = forward(no_packed_keys, True)
        per_forward['fallback'] = [b - a for a, b in zip(before, kernel_launches(mark))]
        fallback_equals_plain = bool(torch.equal(fallback, forward(no_packed_keys, False)))
        finite['fallback'] = bool(torch.isfinite(fallback).all())
    wall = time.perf_counter() - t0
    counted = kernel_launches(mark)
    route_counts, graph = route_launches(mark), counters.since(mark)

    # 2 dynamic calibration forwards and the 2 fallback forwards run plain
    forwards = {(): 2 + 2, all_stages: eval_batches, (1,): 1, (2, 3): 1}
    # each frozen forward's first call captures a graph, one forward run
    # module by module beside it (drive_serving_path): the evaluation's, the
    # two staged ones', the fallback's, the plain one's
    warmups = {(): 2, all_stages: 1, (1,): 1, (2, 3): 1}
    predicted = [sum(table[st][i] * n for st, n in forwards.items()) for i in range(3)]
    on_device = [p + sum(table[st][i] * n for st, n in warmups.items())
                 for i, p in enumerate(predicted)]
    predicted_routes = sum((times(routes[st], n) for st, n in forwards.items()), Counter())
    kernels = ('int4_gemm', 'int8_gemm', 'int8_conv')
    report = dict(arch=arch, input_size=size, batch=batch, grid='W4A4',
                  per_forward_table={'packed': table[all_stages], 'stage_1': table[(1,)],
                                     'stages_2_3': table[(2, 3)], 'plain': table[()]},
                  per_forward_counted=dict(
                      packed=[(b - a) // eval_batches for a, b in zip(after_freeze, after_eval)],
                      **per_forward),
                  forwards=sum(forwards.values()),
                  graph_captures=graph.get('serving_graph.captures', 0),
                  predicted_graph_captures=sum(warmups.values()),
                  graph_replays=graph.get('serving_graph.replays', 0),
                  predicted_graph_replays=eval_batches - 1,
                  launches={k: ran[k] for k in kernels},
                  predicted_launches=dict(zip(kernels, on_device)),
                  counted=dict(zip(kernels, counted)),
                  predicted_counted=dict(zip(kernels, predicted)),
                  routes_per_forward=routes[all_stages], route_counted=route_counts,
                  predicted_route_counted=predicted_routes, frozen_sites=len(scales),
                  packed_out_keys=sum(k.endswith(':out:packed') for k in scales),
                  fallback_equals_plain=fallback_equals_plain,
                  top1=res['top1'], top5=res['top5'], loss=res['loss'],
                  images_per_sec=res['images_per_sec'], finite=finite,
                  packed_path_wall_s=wall)
    return eng, sp, scales, images, report


def check_packed_path(prep):
    """``main``'s checks of ``drive_packed_path``'s report."""
    check(prep['launches']['int4_gemm'] > 0 and prep['launches'] == prep['predicted_launches'],
          f"packed path: the device ran {prep['launches']}, predicted "
          f"{prep['predicted_launches']}")
    check(prep['counted'] == prep['predicted_counted']
          and prep['graph_captures'] == prep['predicted_graph_captures']
          and prep['graph_replays'] == prep['predicted_graph_replays'],
          f"packed path: counted {prep['counted']}, predicted {prep['predicted_counted']}; "
          f"{prep['graph_captures']} captures, {prep['graph_replays']} replays")
    check(prep['per_forward_table']['packed'] == (36, 1, 16)
          and prep['per_forward_counted']['packed'] == [36, 1, 16]
          and prep['per_forward_counted']['stage_1'] == list(prep['per_forward_table']['stage_1'])
          and prep['per_forward_counted']['stages_2_3']
          == list(prep['per_forward_table']['stages_2_3'])
          and prep['per_forward_counted']['fallback'] == list(prep['per_forward_table']['plain'])
          and prep['per_forward_counted']['fallback'][0] == 0 and prep['fallback_equals_plain'],
          f'packed path launches per forward: {prep}')
    check(prep['routes_per_forward'] == Counter(int4_wgmma=36, wgmma=1, im2col_wgmma=16)
          and prep['route_counted'] == prep['predicted_route_counted'],
          f"packed path routes counted {prep['route_counted']}, the route tables predict "
          f"{prep['predicted_route_counted']}")
    check(np.isfinite([prep['top1'], prep['top5'], prep['loss']]).all()
          and all(prep['finite'].values()) and prep['packed_out_keys'] == 4,
          f'packed path output: {prep}')


def packed_flow(eng, sp, scales, images):
    """In the fully packed forward every conv1 and downsample conv other than
    stage 1 block 0's is fed a PackedQTensor, every conv3 a packed residual,
    and nothing is recorded (every scale frozen)."""
    fed = {}
    conv_forward = QConv.forward

    def conv(self, x, ctx, **kw):
        fed[self.site.id] = (type(x).__name__, type(kw.get('residual')).__name__)
        return conv_forward(self, x, ctx, **kw)

    with mock.patch.object(QConv, 'forward', conv):
        logits, aux = eng.make_forward(quantized='serving_int8', act_scales=scales,
                                       packed=True).eager(sp, None, images)
    wrong = []
    for name, m in eng.model.named_modules():
        if not isinstance(m, QConv) or not name.startswith('layer'):
            continue
        x_kind, res_kind = fed[m.site.id]
        first = name.startswith('layer1.0.')
        if name.endswith(('.conv1', '.downsample.0')):
            ok = x_kind == (QTensor.__name__ if first else PackedQTensor.__name__)
        elif name.endswith('.conv3'):
            ok = x_kind == QTensor.__name__ and res_kind == PackedQTensor.__name__
        else:
            ok = x_kind == QTensor.__name__
        if not ok:
            wrong.append(name)
    out = dict(trunk_convs=sum(1 for n, m in eng.model.named_modules()
                               if isinstance(m, QConv) and n.startswith('layer')),
               not_fed_as_expected=wrong, frozen_forward_records=len(aux),
               logits_finite=bool(torch.isfinite(logits).all()))
    emit('packed_flow', **out)
    check(not wrong and not aux and out['logits_finite'],
          f'packed forward does not carry packed codes between blocks: {out}')


def packed_grid_scales(scales):
    """The plain path's comparison scales: ':out' identity codes on the packed
    grid (step absmax / 7; the plain path's +-127 clip is then a no-op), so
    both paths quantize the identity alike."""
    return {k: scales.get(k + ':packed', v) for k, v in scales.items()}


def packed_vs_plain_on_card(eng, sp, scales, images):
    """The packed forward against the plain int8-resident forward given the
    packed-grid ':out' scales: the same separately rounded operations, so the
    logits must be equal."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    packed, _ = eng.make_forward(quantized='serving_int8', act_scales=scales, packed=True)(
        sp, None, images)
    plain, _ = eng.make_forward(quantized='serving_int8',
                                act_scales=packed_grid_scales(scales))(sp, None, images)
    out = dict(equal=bool(torch.equal(packed, plain)),
               max_abs_diff=float((packed - plain).abs().max()), rel_err=rel_err(packed, plain),
               argmax_equal=bool(torch.equal(packed.argmax(-1), plain.argmax(-1))))
    emit('packed_vs_plain_on_card', **out)
    check(out['equal'], f'packed forward != plain forward under packed-grid scales: {out}')


def packed_card_vs_cpu(device, arch='resnet50', size=64):
    """The packed path on the card (kernels) and on the CPU (plain versions)
    from one set of quantized weights at a small input: prepared codes equal,
    frozen scales (the packed keys included) within 1e-5 relative, and on
    either device the packed logits finite and equal to that device's plain
    forward under the packed-grid scales.  The logits of the two devices are
    reported: on a +-7 grid one code flipped by the float stem (cuDNN and the
    CPU sum in another order) moves every code behind it."""
    batches = list(synthetic_batches(2, 2, size=size, seed=1))
    x = batches[0][0]
    cpu = torch.device('cpu')
    model, meta = build_model(arch, device=cpu, seed=0)
    pq_host = QuantEngine(model, QuantPolicy(arch=arch, **W4A4), meta).quantize_params(
        dict(model.state_dict()))
    runs = {}
    for dev in (device, cpu):
        model, meta = build_model(arch, device=dev, seed=0)
        eng = QuantEngine(model, QuantPolicy(arch=arch, **W4A4), meta)
        sp = eng.prepare_serving_params({k: v.to(dev) for k, v in pq_host.items()})
        scales = eng.freeze_serving_scales(sp, batches, packed=True)
        packed, _ = eng.make_forward(quantized='serving_int8', act_scales=scales, packed=True)(
            sp, None, x)
        plain, _ = eng.make_forward(quantized='serving_int8',
                                    act_scales=packed_grid_scales(scales))(sp, None, x)
        runs[dev.type] = ({k: v.cpu() for k, v in sp.items()}, scales, packed.cpu(),
                          bool(torch.equal(packed, plain)))
    (sp_c, sc_c, l_c, eq_c), (sp_h, sc_h, l_h, eq_h) = runs[device.type], runs['cpu']
    codes_equal = all(torch.equal(sp_c[k], sp_h[k]) for k in sp_h if sp_h[k].dtype == torch.int8)
    scale_err = max(abs(sc_c[k] - sc_h[k]) / sc_h[k] for k in sc_h)
    out = dict(arch=arch, input_size=size, prepared_codes_equal=codes_equal,
               frozen_sites=len(sc_c), packed_out_keys=sum(k.endswith(':packed') for k in sc_c),
               frozen_scales_max_rel=scale_err, packed_equals_plain_on_card=eq_c,
               packed_equals_plain_on_cpu=eq_h, logits_rel_card_vs_cpu=rel_err(l_c, l_h),
               argmax_equal_card_vs_cpu=bool(torch.equal(l_c.argmax(-1), l_h.argmax(-1))))
    emit('packed_card_vs_cpu', **out)
    check(codes_equal and set(sc_c) == set(sc_h) and out['packed_out_keys'] == 4
          and scale_err <= 1e-5, f'packed preparation differs between card and CPU: {out}')
    check(eq_c and eq_h and l_c.shape == (2, 1000) and bool(torch.isfinite(l_c).all()),
          f'packed logits: {out}')


def profile_serving_forward(fwd, sp, images):
    """Where the time of one warm frozen serving forward goes: device time in
    the int4 GEMM, the int8 GEMM, the int8 conv, PyTorch's elementwise kernels
    (quantize/dequantize chains, ReLU, residual adds), copies and the rest."""
    for _ in range(2):
        fwd(sp, None, images)
    torch.cuda.synchronize()
    wall_ms, device_us = device_time_by_kernel(lambda: fwd(sp, None, images))
    busy_ms = sum(device_us.values()) / 1e3

    by_class = device_ms_by_class(device_us)
    parts = {f'{name}_ms': by_class[name]
             for name in ('int4_gemm', 'int8_gemm', 'int8_conv', 'elementwise', 'memcpy')}
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    return dict(batch=int(images.shape[0]), wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms), **parts,
                other_ms=busy_ms - sum(parts.values()),
                elementwise_share_of_device=parts['elementwise_ms'] / max(busy_ms, 1e-9),
                device_records=sum(1 for _ in device_us),
                images_per_sec_warm=images.shape[0] / wall_ms * 1e3,
                top_device_ms=[[k[:80], us / 1e3] for k, us in top])


def packed_step_profile(eng, sp, scales, images, card):
    """One warm frozen packed forward beside the plain W4A4 forward of the
    same weights and scales (plain, packed, packed, plain)."""
    plain = eng.make_forward(quantized='serving_int8', act_scales=scales)
    packed = eng.make_forward(quantized='serving_int8', act_scales=scales, packed=True)
    runs = [(name, profile_serving_forward(fwd, sp, images))
            for name, fwd in (('plain', plain), ('packed', packed), ('packed', packed),
                              ('plain', plain))]
    emit('packed_step_profile', card=card,
         plain=[r for n, r in runs if n == 'plain'], packed=[r for n, r in runs if n == 'packed'])


def int4_timing(device, card):
    """The int4 GEMM at the packed path's heaviest shapes: kernel on its route
    and on the mma.sync route (``old_route_ms``), plain version, bound (bytes: A at half a byte a code when packed, the residual
    at half a byte, the output at its stored width) and one library call
    (torch._int_mm on unpacked int8 codes: the int32 product alone, no
    unpacking, no epilogue, a 4-byte output; the port never calls it)."""
    gen = torch.Generator().manual_seed(5)
    rows = []
    out_bytes = {'f32': 4.0, 'bf16': 2.0, 'int8': 1.0, 'packed': 0.5}
    for name in TIMED_INT4:
        m, k, n, a_packed, with_res, _, mode = INT4_CASES[name]
        args, kw = int4_case(name, gen, device)
        ms = cuda_ms(lambda: i4.int4_matmul(*args, **kw))
        old_route_ms = cuda_ms(lambda: int4_launch(args, kw, 'mma_sync'))
        host_paced_ms = cuda_ms(lambda: i4.int4_matmul(*args, **kw), head_start=False)
        plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(*args, **kw), iters=5, warmup=1)
        a_codes = i4.unpack_int4(args[0]) if a_packed else args[0]
        b = args[1].contiguous()
        library_ms = cuda_ms(lambda: torch._int_mm(a_codes, b))
        ops = 2 * m * n * k
        nbytes = (m * k * (0.5 if a_packed else 1.0) + k * n + m * n * out_bytes[mode]
                  + (m * n * 0.5 if with_res else 0.0) + 8 * n)
        bound_ms, bound_by = int8_bound_ms(ops, nbytes)
        rows.append(dict(
            case=name, shape=f'[{m},{k}{"p" if a_packed else ""}]x[{k},{n}]'
                             f'{" + residual" if with_res else ""}', out=mode,
            route=i4.int4_route(k, a_packed), ms=ms, old_route_ms=old_route_ms,
            host_paced_ms=host_paced_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, tera_ops_per_s=ops / ms / 1e9,
            gb_per_s=nbytes / ms / 1e6))
    emit('int4_timing', card=card, int4_gemm=rows)
    return rows


def copy_case(shape, gen, device):
    """int8 values over the whole range, with both ends of it up front so that
    every scalar wraps somewhere (127 + 1 -> -128, -128 - 1 -> 127)."""
    a = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)
    flat = a.view(-1)
    flat[0], flat[1], flat[2] = 127, -128, -127
    return a.to(device)


def int32_total(psums):
    return int(psums.sum().to(torch.int32))


def copy_err(got, want):
    """The worst difference of one stream-copy result (output, partial sums)
    from another: the larger of the outputs' largest difference and the
    difference of the partial sums' int32 totals."""
    (got, got_p), (want, want_p) = got, want
    return max(int((got.int() - want.int()).abs().max()),
               abs(int32_total(got_p) - int32_total(want_p)))


def stream_copy_vs_plain(device):
    """The stream-copy kernel against its plain version: the output and the
    int32 total of the partial sums must be equal for every scalar and shape,
    and a chain of 36 dependent steps at the probe's shape must end in the
    same tensor and the same carries.  Returns the worst difference measured
    (``copy_err`` over the cases and the chain)."""
    gen = torch.Generator().manual_seed(6)
    mismatches, cases, worst = [], 0, 0
    for shape in COPY_SHAPES:
        a = copy_case(shape, gen, device)
        for sv in (-1, 0, 1):
            s = torch.full((1,), sv, dtype=torch.int32, device=device)
            err = copy_err(sc.stream_copy(a, s), sc.stream_copy_plain(a, s))
            cases, worst = cases + 1, max(worst, err)
            if err:
                mismatches.append([list(shape), sv, err])
    # an unaligned buffer takes the kernel's byte-wise path
    a = copy_case((100003,), gen, device)[3:]
    s = torch.ones(1, dtype=torch.int32, device=device)
    err = copy_err(sc.stream_copy(a, s), sc.stream_copy_plain(a, s))
    cases, worst = cases + 1, max(worst, err)
    if err:
        mismatches.append(['unaligned', 1, err])

    def chain(step, steps=36):
        c = copy_case(PROBE_SHAPE, torch.Generator().manual_seed(7), device)
        if int(c.sum()) % 2 == 0:
            c.view(-1)[3] += 1    # an odd sum: the carries are not all 0
        s, carries = torch.zeros(1, dtype=torch.int32, device=device), []
        for _ in range(steps):
            c, psums = step(c, s)
            s = sc.stream_copy_carry(psums)
            carries.append(s)
        return c, torch.cat(carries).tolist()

    got, got_carries = chain(sc.stream_copy)
    want, want_carries = chain(sc.stream_copy_plain)
    chain_err = max(int((got.int() - want.int()).abs().max()),
                    max(abs(g - w) for g, w in zip(got_carries, want_carries)))
    worst = max(worst, chain_err)
    emit('stream_copy_vs_plain', cases=cases, mismatches=mismatches, chain_steps=36,
         chain_max_abs_err=chain_err, chain_carries=got_carries, max_abs_err=worst)
    check(not mismatches, f'stream copy != plain: {mismatches}')
    check(chain_err == 0 and any(got_carries),
          'a chain of 36 stream-copy steps differs from the plain chain')
    return float(worst)


def call_signature(args, kw):
    """What tells one call of a kernel wrapper from another for the kernel:
    every tensor's shape and type, every flag, mode and stride; a float's
    value does not."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), str(v.dtype)
        if isinstance(v, (tuple, list)):
            return tuple(one(i) for i in v)
        return 'float' if isinstance(v, float) else v
    return tuple(one(v) for v in args), tuple(sorted((k, one(v)) for k, v in kw.items()))


def fake_quant_step(x, delta, offset, qmax, channel_dim=None, **_):
    """The grid step of each element of ``x`` in an affine fake-quant call."""
    step = affine_qparams(delta, offset, qmax, device=x.device)[0]
    if step.ndim and channel_dim is not None:
        shape = [1] * x.ndim
        shape[channel_dim] = -1
        step = step.reshape(shape)
    return step


class HeldToPlain:
    """Stand-ins for the five kernel wrappers.  While ``active()``, the first
    call of every distinct signature runs the kernel and then the plain
    version on the same inputs and holds one against the other: integer and
    float32 outputs equal; bfloat16 outputs within one ulp, a fake-quant's
    within one step of the element's own grid; the stream copy by
    ``copy_err``.  Stochastic fake-quant calls pass through: the plain version
    draws other noise, and the bench checks their statistics itself.  A
    kernel launched through a stand-in is counted as any other launch; the
    plain version launches none."""

    def __init__(self):
        self.seen = set()
        self.report = {name: dict(signatures=0, max_abs_err=0.0, bf16_over=0)
                       for name in ('fake_quant', 'int8_gemm', 'int8_conv', 'int4_gemm',
                                    'stream_copy')}
        self.failures = []

    def hold(self, name, sig, got, want, step=None):
        rep = self.report[name]
        rep['signatures'] += 1
        err, over = 0.0, 0
        if name == 'stream_copy':
            err = float(copy_err(got, want))
        elif got.dtype != torch.bfloat16:
            err = float((got.double() - want.double()).abs().max())
        elif step is None:
            over = bf16_over_one_ulp(got, want)
        else:
            over = int(((got.float() - want.float()).abs() > step).sum())
        rep['max_abs_err'] = max(rep['max_abs_err'], err)
        rep['bf16_over'] += over
        if err or over:
            self.failures.append([name, repr(sig)[:300], err, over])

    def stand_in(self, name, real, plain, step_of=None):
        @functools.wraps(real)
        def call(*args, **kw):
            got = real(*args, **kw)
            sig = (real.__name__,) + call_signature(args, kw)
            if kw.get('stochastic') or sig in self.seen:
                return got
            self.seen.add(sig)
            want = plain(*args, **kw)
            self.hold(name, sig, got, want, step_of(*args, **kw) if step_of else None)
            return got
        return call

    @contextlib.contextmanager
    def active(self):
        wrappers = ((fq, 'fake_quant_fused', 'fake_quant', fq.fake_quant_fused_plain,
                     fake_quant_step),
                    (fq, 'fake_quant_kernel_semantics_fused', 'fake_quant',
                     fq.fake_quant_kernel_semantics_plain,
                     lambda x, delta, offset, num_bits: as_step(delta, num_bits, x.device)),
                    (im, 'int8_matmul_dequant', 'int8_gemm', im.int8_matmul_dequant_plain, None),
                    (ic, 'int8_conv_dequant', 'int8_conv', ic.int8_conv_dequant_plain, None),
                    (i4, 'int4_matmul', 'int4_gemm', i4.int4_matmul_plain, None),
                    (sc, 'stream_copy', 'stream_copy', sc.stream_copy_plain, None))
        with contextlib.ExitStack() as stack:
            for module, attr, name, plain, step_of in wrappers:
                stack.enter_context(mock.patch.object(
                    module, attr, self.stand_in(name, getattr(module, attr), plain, step_of)))
            yield self


def as_step(delta, num_bits, device):
    """The grid step of a per-tensor fake-quant with the reference semantics."""
    return torch.as_tensor(delta, dtype=torch.float32, device=device) / (2.0 ** num_bits - 1.0)


def bench_calls_vs_plain(device):
    """Every kernel at every shape the bench path gives it, on the path's own
    data: the whole bench (ResNet-50 bfloat16 at batch 128, its calibration
    batches, the sweep at 64 and 256, MobileNet-v2, the probes) runs once with
    ``HeldToPlain`` active, its printed lines discarded.  This run comes
    before ``bench_path`` starts its count of launches and its times are not
    read.  Returns the worst float32 or integer difference by kernel."""
    held = HeldToPlain()
    t0 = time.perf_counter()
    with held.active(), contextlib.redirect_stdout(io.StringIO()):
        bench.run(batch=BENCH_BATCH, device=device)
    torch.cuda.synchronize()
    emit('bench_calls_vs_plain', batch=BENCH_BATCH, seconds=time.perf_counter() - t0,
         failures=held.failures, **held.report)
    check(all(r['signatures'] > 0 for r in held.report.values()),
          f'a kernel of the bench path was held to its plain version at no shape: {held.report}')
    check(not held.failures, f'kernel != plain on the bench path: {held.failures}')
    return {name: r['max_abs_err'] for name, r in held.report.items()}


def forward_kinds(counts):
    """Stand-ins for ``torch.func.functional_call`` and
    ``QuantEngine.make_forward`` that count the forwards of a run by what
    they launch: serving forwards by model and the stages that run packed,
    quantizing forwards by model.  A forward of ``make_forward`` counts once
    a call, whether it runs module by module, captures its CUDA graph (a
    warm-up and a capture, which the counters count as the one forward its
    first replay runs) or replays it; a ``functional_call`` made outside one
    (calibration) counts once."""
    real_call, real_make = torch.func.functional_call, QuantEngine.make_forward
    inside = []

    def kind(model, ctx):
        if isinstance(ctx, ServingInt8Context):
            stages = model._packed_stages(ctx) if hasattr(model, '_packed_stages') else ()
            return ('serving', type(model).__name__, tuple(stages))
        if isinstance(ctx, QuantizeContext):
            return ('quantize', type(model).__name__, ())
        return None

    def count(key):
        if key is not None:
            counts[key] = counts.get(key, 0) + 1

    def call(model, params, args, *rest, **kw):
        if not inside:
            count(kind(model, args[1]))
        return real_call(model, params, args, *rest, **kw)

    def make(engine, *args, **kw):
        fwd = real_make(engine, *args, **kw)
        key = kind(engine.model, fwd.context(None))

        def counted(f):
            def forward(*args):
                count(key)
                inside.append(key)
                try:
                    return f(*args)
                finally:
                    inside.pop()
            return forward

        out = counted(fwd)
        out.eager = counted(fwd.eager)
        return out

    return call, make


def bench_path(device, card):
    """The throughput bench through its entry point (``bench.run``) at full
    width: ResNet-50 and MobileNet-v2, 224x224, batch 128, bfloat16.  The
    launches are counted from just before to just after; the forwards'
    launches are held against the models' site tables (forwards counted by
    kind as they run), the probes' against what each probe is."""
    tables, routes, n_weights, n_sites, depthwise = {}, {}, {}, {}, 0
    for arch in ('resnet50', 'mobilenet_v2'):
        model, _ = build_model(arch, device='cpu')
        kind = type(model).__name__
        n_weights[kind] = sum(1 for m in model.modules() if isinstance(m, (QConv, QLinear)))
        n_sites[kind] = len(discover_sites(model, (1, 3, 224, 224)))
        stage_sets = ((), (1, 2, 3, 4)) if arch == 'resnet50' else ((),)
        for stages in stage_sets:
            tables[kind, stages] = launch_table(model, stages)
            routes[kind, stages] = route_table(model, stages)
        if arch == 'mobilenet_v2':
            depthwise = sum(1 for m in model.modules() if isinstance(m, QConv) and m.groups > 1)
    forwards, weight_passes = {}, {}
    quantize_params = QuantEngine.quantize_params

    def counting_quantize_params(self, params):
        kind = type(self.model).__name__
        weight_passes[kind] = weight_passes.get(kind, 0) + 1
        return quantize_params(self, params)

    mark = counters.snapshot()
    t0 = time.perf_counter()
    call, make = forward_kinds(forwards)
    with mock.patch.object(torch.func, 'functional_call', call), \
            mock.patch.object(QuantEngine, 'make_forward', make), \
            mock.patch.object(QuantEngine, 'quantize_params', counting_quantize_params):
        headline, by_section = bench.run(batch=BENCH_BATCH, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.by_kernel(counters.since(mark))
    route_counts = route_launches(mark)

    predicted = dict.fromkeys(launches, 0)
    # the int8-rate probe's product has K = 16384: the TMA + wgmma route
    predicted_routes = Counter(wgmma=by_section['mxu_rate_probe']['int8_gemm'])
    for (mode, kind, stages), n in forwards.items():
        if mode == 'quantize':
            predicted['fake_quant'] += n * n_sites[kind]
        else:
            int4, gemm, conv = tables[kind, stages]
            predicted['int4_gemm'] += n * int4
            predicted['int8_gemm'] += n * gemm
            predicted['int8_conv'] += n * conv
            predicted_routes += times(routes[kind, stages], n)
    predicted['fake_quant'] += sum(n * n_weights[kind] for kind, n in weight_passes.items())
    forward_sections = ('bench', 'batch_sweep', 'serving_spread', 'mobilenet_serving')
    measured = {k: sum(by_section[sec][k] for sec in forward_sections) for k in launches}
    report = dict(
        arch='resnet50 + mobilenet_v2', input_size=224, batch=BENCH_BATCH, dtype='bfloat16',
        per_forward_table={'resnet50_plain': tables['ResNet', ()],
                           'resnet50_packed': tables['ResNet', (1, 2, 3, 4)],
                           'mobilenet_v2': tables['MobileNetV2', ()]},
        routes_per_forward={'resnet50_plain': routes['ResNet', ()],
                            'resnet50_packed': routes['ResNet', (1, 2, 3, 4)],
                            'mobilenet_v2': routes['MobileNetV2', ()]},
        route_launches=route_counts, predicted_route_launches=predicted_routes,
        forwards={f'{m}:{k}:{"packed" if st else "plain"}': n
                  for (m, k, st), n in sorted(forwards.items())},
        weight_passes=weight_passes, launches=launches, launches_by_section=by_section,
        forward_launches=measured, predicted_forward_launches=predicted,
        mobilenet_depthwise_convs=depthwise, headline=headline, bench_path_wall_s=wall)
    emit('bench_path', card=card, **report)
    check(all(v > 0 for v in launches.values()),
          f'a kernel of the bench path was never launched: {launches}')
    check(measured == predicted,
          f'bench forwards launched {measured}, the site tables predict {predicted}')
    # MobileNet-v2: the 17 depthwise convs on the direct route, its two K = 24
    # GEMMs on mma.sync, the 33 others on wgmma; ResNet-50 all on wgmma and
    # the im2col route, packed its 36 int4 GEMMs on wgmma
    check(routes['MobileNetV2', ()] == Counter(wgmma=33, mma_sync=2, depthwise=17)
          and routes['ResNet', ()] == Counter(wgmma=34, im2col_wgmma=19)
          and routes['ResNet', (1, 2, 3, 4)] == Counter(int4_wgmma=36, wgmma=1, im2col_wgmma=16)
          and route_counts == predicted_routes,
          f'bench routes launched {route_counts}, the route tables predict {predicted_routes}')
    probes = {sec: {k: v for k, v in by_section[sec].items() if v}
              for sec in ('stochastic_smoke', 'mxu_rate_probe', 'dma_probe')}
    check(probes['stochastic_smoke'] == {'fake_quant': 3}
          and set(probes['mxu_rate_probe']) == {'int8_gemm'}
          and set(probes['dma_probe']) == {'stream_copy'}
          and probes['dma_probe']['stream_copy'] % 36 == 0,
          f'bench probes launched {probes}')
    check(depthwise == 17 and headline['mobilenet_per_channel_act_sites'] == depthwise
          and tables['MobileNetV2', ()][2] == depthwise,
          f"MobileNet-v2 vector-scale sites {headline['mobilenet_per_channel_act_sites']}, "
          f'depthwise convs {depthwise}')
    rates = [headline[k] for k in (
        'value', 'vs_baseline', 'w4a4_sim_images_per_sec', 'bf16_images_per_sec',
        'w4a4_serving_images_per_sec', 'w4a4_packed_images_per_sec',
        'mobilenet_serving_images_per_sec', 'int8_dot_tops', 'dma_copy_gbps')]
    shares = [headline[k] for k in ('mfu_int8', 'bandwidth_util', 'w4a4_packed_mfu_int8',
                                    'int8_dot_mfu', 'int8_gemm_kernel_mfu',
                                    'serving_idle_share', 'w4a4_packed_idle_share')]
    check(np.isfinite(rates).all() and min(rates) > 0, f'bench rates: {headline}')
    check(np.isfinite(shares).all() and 0 <= min(shares) and max(shares) <= 1,
          f'bench shares of a peak: {headline}')
    check(headline['cuda_stochastic_ok'], f'stochastic rounding statistics: {headline}')
    return launches


def bf16_kernels_vs_plain_end_to_end(device, images, arch='resnet50'):
    """The bfloat16 model's W8A8 serving forward and W4A4 packed forward, on
    the bench's own batch, with the kernels and with all wrappers patched to
    their plain versions.  The float32 epilogues are bit-identical and both
    sides round them to bf16 the same way, so the logits should be equal; the
    stated tolerance is what one bf16 store off by one ulp could move them:
    relative error <= 2^-7, argmax equal."""
    model, meta = build_model(arch, dtype='bfloat16', device=device, seed=0)
    params = dict(model.state_dict())
    cal = [(images[:16], np.zeros(16, np.int32))]
    for phase, grid, packed in (('bf16_serving_kernels_vs_plain_end_to_end', W8A8, False),
                                ('bf16_packed_kernels_vs_plain_end_to_end', W4A4, True)):
        eng = QuantEngine(model, QuantPolicy(arch=arch, **grid), meta)
        sp = eng.prepare_serving_params(eng.quantize_params(params))
        scales = eng.freeze_serving_scales(sp, cal, packed=packed)
        kernels_vs_plain_end_to_end(phase, eng, sp, scales, images, packed=packed, tol=2.0 ** -7)


def mobilenet_kernels_vs_plain_end_to_end(device, images, arch='mobilenet_v2'):
    """MobileNet-v2's W8A8 serving forward as the bench serves it (float32
    activations, 17 per-channel depthwise scale vectors frozen from 16
    images), with the kernels and with the wrappers patched to their plain
    versions: exact integer sums and the same float stem, so relative error
    <= 1e-6 and equal argmax."""
    model, meta = build_model(arch, device=device, seed=0)
    eng = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta)
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))
    scales = eng.freeze_serving_scales(sp, [(images[:16], np.zeros(16, np.int32))])
    check(sum(1 for v in scales.values() if np.ndim(v) == 1) == 17,
          'MobileNet-v2 froze other than 17 vector scales')
    kernels_vs_plain_end_to_end('mobilenet_kernels_vs_plain_end_to_end', eng, sp, scales, images)


def stream_copy_timing(device, card):
    """The stream-copy kernel at the probe's shape: one step alone, one step
    of the dependent chain (with the carry's PyTorch launches), the plain
    version, the byte bound (2 x 102.76 MB) and one library call
    (``torch.add`` of an int8 scalar into a preallocated int8 output: the copy
    alone, without the sums; the port never calls it)."""
    gen = torch.Generator().manual_seed(8)
    a = copy_case(PROBE_SHAPE, gen, device)
    s = torch.zeros(1, dtype=torch.int32, device=device)
    ms = cuda_ms(lambda: sc.stream_copy(a, s))
    host_paced_ms = cuda_ms(lambda: sc.stream_copy(a, s), head_start=False)
    plain_ms = cuda_ms(lambda: sc.stream_copy_plain(a, s), iters=5, warmup=1)
    out, one = torch.empty_like(a), torch.ones((), dtype=torch.int8, device=device)
    library_ms = cuda_ms(lambda: torch.add(a, one, out=out))

    def chain(steps=36):
        c, carry = a, s
        for _ in range(steps):
            c, psums = sc.stream_copy(c, carry)
            carry = sc.stream_copy_carry(psums)

    chain_ms_per_step = cuda_ms(chain, iters=3, warmup=1) / 36
    nbytes = 2 * a.numel()
    row = dict(shape=list(PROBE_SHAPE), dtype='int8', ms=ms, chain_ms_per_step=chain_ms_per_step,
               host_paced_ms=host_paced_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
               gb_per_s=nbytes / ms / 1e6, chain_gb_per_s=nbytes / chain_ms_per_step / 1e6)
    emit('stream_copy_timing', card=card, **row)
    return row


# ---------------------------------------------------------------- the CLI path

CLI_BATCH = 8
CLI_SITES = ('conv0_activation', 'conv2_activation', 'avgpool0_out')  # stem, stage 1, fc input
CLI_ORDER = ['conv2_activation', 'conv10_activation', 'linear0_activation']
MODE_NAMES = {fq.AFFINE: 'affine', fq.STOCHASTIC: 'stochastic', fq.MINMAX: 'reference_per_tensor'}


def predicted_site_modes(policy, sites, stats=None, frozen=()):
    """Fake-quant launches of one quantized forward by kernel mode, from the
    site table and the quantizer's dispatch (ops/quantizer.py): a frozen site
    one affine launch; a dynamic one by its branch (KLD and per-tensor
    min/max: reference_per_tensor; clipped or per-channel: affine, or
    stochastic under -s); a mid-tread site none."""
    ctx = QuantizeContext(policy, stats=stats)
    modes = Counter()
    for site, shape in sites:
        cfg = ctx.config_for(site)
        if cfg is None:
            continue
        if site.id in frozen and not (cfg.measure_entropy or cfg.stochastic):
            modes['affine'] += 1
            continue
        per_channel = cfg.pcq_a and len(shape) == 4 and (shape[2] > 1 or shape[3] > 1)
        if cfg.kld:
            modes['reference_per_tensor'] += 1
        elif cfg.clipping != 'no' and cfg.mtd_quant:
            continue
        elif cfg.clipping != 'no' or cfg.pcq_w or per_channel:
            modes['stochastic' if cfg.stochastic else 'affine'] += 1
        else:
            modes['stochastic' if cfg.stochastic else 'reference_per_tensor'] += 1
    return modes


def predicted_weight_modes(policy, params):
    """Fake-quant launches of the weight pass by mode: one a conv or linear
    weight, affine per channel under -pcq_w, none for a mid-tread weight."""
    configs = policy.tag_configs()
    modes = Counter()
    for name, w in params.items():
        if not (name.endswith('.weight') and w.ndim in (2, 4)):
            continue
        cfg = configs['weight' if w.ndim == 4 or w.shape[0] != 1000 else 'weight_classifier']
        if cfg is None or (cfg.pcq_w and cfg.mtd_quant):
            continue
        modes['affine' if cfg.pcq_w else 'reference_per_tensor'] += 1
    return modes


@contextlib.contextmanager
def cli_instrumented():
    """Counts the fake-quant kernel's launches by mode and records the logits
    of every forward made (the CLI's, or a phase's own)."""
    modes, logits = Counter(), []
    real_launch, real_make_forward = fq.launch, QuantEngine.make_forward

    def launch(x, p0, p1, qmax, channel_dim, mode, seed=0):
        modes[MODE_NAMES[mode]] += 1
        return real_launch(x, p0, p1, qmax, channel_dim, mode, seed)

    def make_forward(self, *a, **kw):
        fwd = real_make_forward(self, *a, **kw)

        def recording(params, stats, images):
            out, aux = fwd(params, stats, images)
            logits.append(out.detach().clone())
            return out, aux
        return recording

    with mock.patch.object(fq, 'launch', launch), \
            mock.patch.object(QuantEngine, 'make_forward', make_forward):
        yield modes, logits


def cli_run(argv):
    """One in-process call of the port's inference_sim on the card: its
    stdout lines, result line, logits, fake-quant launches (total and by
    mode) and wall seconds."""
    from cnn_quantization_tpu_torch.cli import inference_sim
    buf = io.StringIO()
    mark = counters.snapshot()
    with cli_instrumented() as (modes, logits), contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        rc = inference_sim.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0, f'inference_sim {argv}: exit {rc}')
    res = json.loads(lines[-1]) if lines and lines[-1].startswith('{') else None
    return dict(lines=lines, res=res, logits=logits, modes=modes, wall_s=wall,
                launches=launched_since(mark)['fake_quant'])


def read_csv(path):
    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def kld_sweeps_agree(device, params, engine, images):
    """The C++ sweep against the port's numpy sweep on the card's captured
    activations of three sites, two images each: within two bins."""
    from cnn_quantization_tpu_torch.calib import kld
    from cnn_quantization_tpu_torch.calib.capture import make_capture_fn
    rows = kld.acts_to_host(make_capture_fn(engine)(params, images))
    out = {}
    for site in CLI_SITES:
        r = rows[site][:2]
        native = kld.kld_threshold_batch(r)
        plain = kld.kld_threshold_batch(r, use_native=False)
        bins = 2 * 2 * np.abs(r).max(axis=1) / 2001
        out[site] = dict(native=native.tolist(), numpy=plain.tolist(),
                         bins_apart=(np.abs(native - plain) / (bins / 2)).tolist())
        check(np.all(np.abs(native - plain) <= bins), f'KLD sweeps disagree at {site}: {out[site]}')
    return out


def cli_path(device, card, arch='resnet50', size=224, batch=CLI_BATCH):
    """The port's inference_sim in-process on the card for ResNet-50 at
    224x224 and full width, batch 8, seeded random weights: (a) KLD collect
    then use, frozen and dynamic (-me); (b) mid-tread; (c) stochastic
    rounding; (d) the sweeps and outputs (-ep, -ct, -ms, -dd).  Every run's
    fake-quant launches by mode against the site table's prediction."""
    from cnn_quantization_tpu_torch.calib import capture, kld
    model, meta = build_model(arch, device=device, seed=0)
    params = dict(model.state_dict())
    sites = discover_sites(model, (1, 3, size, size))
    base = ['-a', arch, '--input_size', str(size), '-b', str(batch), '--subset', str(2 * batch)]
    w4a4 = ['--qtype', 'int4', '-qw', 'int4']
    report, launches = dict(arch=arch, input_size=size, batch=batch, sites=len(sites)), 0

    def held(name, run, predicted):
        nonlocal launches
        launches += run['launches']
        check(run['modes'] == predicted and sum(predicted.values()) == run['launches'],
              f'{name}: fake-quant launches {dict(run["modes"])}, predicted {dict(predicted)}')
        finite = all(bool(torch.isfinite(t).all()) for t in run['logits'])
        check(finite, f'{name}: non-finite logits')
        entry = dict(launches=dict(run['modes']), wall_s=run['wall_s'])
        if run['res'] is not None:
            entry.update(images_per_sec=run['res']['images_per_sec'], loss=run['res']['loss'])
        report[name] = entry
        return entry

    with tempfile.TemporaryDirectory() as home, contextlib.chdir(home), \
            mock.patch.dict(os.environ, {'HOME': home}):
        # (a) KLD: collect thresholds over 16 images, timing the three stages
        t = Counter()
        real_capture, real_host, real_sweep = (capture.make_capture_fn, kld.acts_to_host,
                                               kld.kld_threshold_batch)

        def timed(key, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                t[key] += time.perf_counter() - t0
                return out
            return call

        with mock.patch.object(capture, 'make_capture_fn',
                               lambda eng: timed('capture_s', real_capture(eng))), \
                mock.patch.object(kld, 'acts_to_host', timed('host_copy_s', real_host)), \
                mock.patch.object(kld, 'kld_threshold_batch', timed('sweep_s', real_sweep)):
            run = cli_run(base + w4a4 + ['-sm', 'collect', '-kld', '-cs', str(2 * batch)])
        # collect mode runs no weight pass: three error-column launches a site and batch
        held('kld_collect', run, Counter(affine=3 * len(sites) * 2))
        report['kld_collect'].update({k: t[k] for k in ('capture_s', 'host_copy_s', 'sweep_s')})
        stats = load_stats(os.path.join(home, 'mxt-sim-tpu', 'statistics', f'{arch}_kld_int4.npz'))
        missing = [s.id for s, _ in sites for k in ('min', 'mean', 'max')
                   if f'scalar/{k}_kld_th' not in stats.get(s.id, {})]
        check(not missing, f'sites without KLD thresholds: {missing}')
        eng = QuantEngine(model, QuantPolicy(arch=arch), meta)
        images = next(synthetic_batches(batch, 1, size=size, seed=12345))[0]
        report['kld_native_vs_numpy'] = kld_sweeps_agree(device, params, eng, images)

        kld_use = base + w4a4 + ['-pcq_w', '-sm', 'use', '-kld']
        policy = QuantPolicy(arch=arch, qtype='int4', qweight='int4', pcq_weights=True, kld=True)
        run = cli_run(kld_use)
        check(f'Froze qparams for {len(sites)} sites' in run['lines'], 'not every KLD site froze')
        held('kld_use_frozen', run, predicted_weight_modes(policy, params)
             + times(Counter(affine=len(sites)), 2))
        # -me keeps the entropy-measuring sites dynamic: the KLD branch through
        # the kernel's reference_per_tensor mode, each call held to the plain version
        hold = dict(calls=0, max_abs_err=0.0)
        real_sem = fq.fake_quant_kernel_semantics_fused

        def semantics(x, delta, offset, num_bits):
            got = real_sem(x, delta, offset, num_bits)
            want = fq.fake_quant_kernel_semantics_plain(x, delta, offset, num_bits)
            hold['calls'] += 1
            hold['max_abs_err'] = max(hold['max_abs_err'], float((got - want).abs().max()))
            return got

        me_policy = dataclasses.replace(policy, measure_entropy=True)
        qparams = QuantEngine(model, me_policy, meta).freeze_qparams(
            stats, input_shape=(1, size, size, 3))
        with mock.patch.object(fq, 'fake_quant_kernel_semantics_fused', semantics):
            run = cli_run(kld_use + ['-me', '--subset', str(batch)])
        per_forward = predicted_site_modes(me_policy, sites, stats, frozen=qparams)
        held('kld_use_dynamic', run, predicted_weight_modes(me_policy, params) + per_forward)
        check(hold['calls'] == per_forward['reference_per_tensor'] > 0
              and hold['max_abs_err'] == 0.0, f'reference_per_tensor vs plain: {hold}')
        report['kld_use_dynamic']['held_to_plain'] = hold

        # (b) mid-tread with bit allocation, measuring the code entropy
        mtq = w4a4 + ['-mtq', '-c', 'laplace', '-pcq_w', '-pcq_a', '-baa', '-baw', '-me']
        policy = QuantPolicy(arch=arch, qtype='int4', qweight='int4', pcq_weights=True,
                             pcq_act=True, clipping='laplace', bit_alloc_act=True,
                             bit_alloc_weight=True, measure_entropy=True, mtd_quant=True)
        run = cli_run(base + mtq)
        per_forward = predicted_site_modes(policy, sites)
        activation_sites = sum(s.tag == 'activation' for s, _ in sites)
        check(sum(per_forward.values()) == len(sites) - activation_sites - 1,
              f'mid-tread: activation sites would launch fake-quant: {per_forward}')
        entry = held('mid_tread', run, predicted_weight_modes(policy, params)
                     + times(per_forward, 2))
        entry['avg_entropy'] = run['res']['avg_entropy']
        check(0.0 < entry['avg_entropy'] <= 4.0, f"mid-tread entropy {entry['avg_entropy']}")

        # (c) stochastic rounding on the headline recipe: seeded
        headline = w4a4 + ['-pcq_w', '-pcq_a', '-c', 'laplace', '-baa', '-baw', '-bcw']
        policy = QuantPolicy(arch=arch, **HEADLINE, stochastic=True)
        runs = {}
        for name, extra in (('stochastic_seed1', ['-s', '--seed', '1']),
                            ('stochastic_seed1_again', ['-s', '--seed', '1']),
                            ('stochastic_seed2', ['-s', '--seed', '2']),
                            ('deterministic_seed1', ['--seed', '1'])):
            runs[name] = cli_run(base + headline + extra)
            p = policy if '-s' in extra else dataclasses.replace(policy, stochastic=False)
            held(name, runs[name], predicted_weight_modes(p, params)
                 + times(predicted_site_modes(p, sites), 2))
        same = all(torch.equal(a, b) for a, b in zip(runs['stochastic_seed1']['logits'],
                                                     runs['stochastic_seed1_again']['logits']))
        other = any(not torch.equal(a, b) for a, b in zip(runs['stochastic_seed1']['logits'],
                                                          runs['stochastic_seed2']['logits']))
        noisy = any(not torch.equal(a, b) for a, b in zip(runs['stochastic_seed1']['logits'],
                                                          runs['deterministic_seed1']['logits']))
        report['stochastic'] = dict(
            stochastic_launches_per_forward=predicted_site_modes(policy, sites)['stochastic'],
            same_seed_identical=same, other_seed_differs=other, noise_moves_logits=noisy)
        check(same and other and noisy, f"stochastic: {report['stochastic']}")

        # (d) the sweeps and outputs, one batch each
        one = ['-a', arch, '--input_size', str(size), '-b', str(batch), '--subset', str(batch)]
        recipe = w4a4 + ['-pcq_w', '-pcq_a', '-c', 'laplace']
        run = cli_run(one + recipe + ['-ep'])
        report['eval_precision'] = dict(wall_s=run['wall_s'], launches=dict(run['modes']))
        launches += run['launches']
        cols, rows = read_csv(f'results/precision/{arch}_laplace_clipping.csv')
        check(cols == ['dtype', 'val_prec1', 'val_prec5']
              and [r[0] for r in rows] == ['fp32', 'int8', 'int7', 'int6', 'int5', 'int4'],
              f'-ep CSV: {cols} {rows}')
        with open('order.json', 'w') as f:
            json.dump(CLI_ORDER, f)
        run = cli_run(one + recipe + ['-ct', '--order_file', 'order.json'])
        report['custom_test'] = dict(wall_s=run['wall_s'], launches=dict(run['modes']))
        launches += run['launches']
        cols, rows = read_csv(f'results/custom_test/{arch}_max_mse_laplace_cliping_'
                              'layer_selection.csv')
        check(cols == ['num_8bit_layers', 'indexes', 'val_prec1', 'val_prec5']
              and [r[0] for r in rows] == ['1', '2', '3', '4']
              and rows[-1][1] == str(['conv0_activation'] + CLI_ORDER), f'-ct CSV: {rows}')
        run = cli_run(one + recipe + ['-ms'])
        report['measure_stats'] = dict(wall_s=run['wall_s'], launches=dict(run['modes']))
        launches += run['launches']
        cols, rows = read_csv(os.path.join(home, 'mxt-sim-tpu', 'distance', arch,
                                           f'{arch}_distance.csv'))
        check(cols == ['', 'norm_fp', 'norm_q', 'mse', 'cos', 'rel_err']
              and sorted(r[0] for r in rows) == sorted(s.id for s, _ in sites)
              and all(np.isfinite(float(v)) for r in rows for v in r[1:]), f'-ms CSV: {cols}')
        run = cli_run(['-a', arch, '--input_size', str(size), '-b', '2', '--subset', '2']
                      + recipe + ['-dd', 'dump'])
        report['dump_dir'] = dict(wall_s=run['wall_s'], launches=dict(run['modes']))
        launches += run['launches']
        shapes = {s.id: [2, *shape[1:]] for s, shape in sites}
        dumped = {f[:-len('.npy')]: list(np.load(os.path.join('dump', 'batch0', f),
                                                 mmap_mode='r').shape)
                  for f in os.listdir(os.path.join('dump', 'batch0'))}
        check(dumped == shapes, f'-dd files: {sorted(dumped)}')
    report['launches'] = launches
    emit('cli_path', card=card, **report)
    return report


# ---------------------------------------------------------------- the rest of the zoo

ZOO_ARCHS = ('vgg16', 'vgg16_bn', 'alexnet', 'squeezenet1_0', 'inception_v3', 'googlenet',
             'densenet121', 'shufflenet')
ZOO_BATCH = 32
# VGG-16 mid-tread with bit allocation and the entropy rate (README's fifth
# experiment), two batches of 32 through the CLI
ZOO_CLI = ['-a', 'vgg16', '-b', '32', '-pcq_w', '-pcq_a', '--qtype', 'int4', '-qw', 'int4',
           '-c', 'laplace', '-baa', '-baw', '-bcw', '-bata', '5.3', '-batw', '5.3', '-mtq', '-me',
           '-ss', '64']


def zoo_simulation(device, arch, size, batch):
    """The W4A4 headline simulation of one architecture: weight pass,
    statistics on one batch, qparam freeze, two frozen evaluation batches;
    fake-quant launches by mode against the site table's prediction.
    Returns (engine, quantized params, qparams, stats, report)."""
    model, meta = build_model(arch, device=device, seed=0, input_size=size)
    params = dict(model.state_dict())
    policy = QuantPolicy(arch=arch, **HEADLINE)
    eng = QuantEngine(model, policy, meta)
    sites = discover_sites(model, (1, 3, size, size))
    batches = list(synthetic_batches(batch, 3, size=size, seed=12345))
    mark = counters.snapshot()
    with cli_instrumented() as (modes, _):
        t0 = time.perf_counter()
        params_q = eng.quantize_params(params)
        weight_modes = Counter(modes)
        summary = collect_statistics(eng.make_collect(err_bits=4), params, batches[:1])
        qparams = eng.freeze_qparams(summary, input_shape=(1, size, size, 3))
        res = evaluate(eng, params_q, batches[1:], stats=summary, qparams=qparams)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    # one launch a weight; three error columns a site for the statistics
    # batch; one launch a site and evaluation batch, by its frozen mode
    predicted = (predicted_weight_modes(policy, params) + Counter(affine=3 * len(sites))
                 + times(predicted_site_modes(policy, sites, summary, frozen=qparams), 2))
    report = dict(sites=len(sites), frozen_sites=len(qparams), launches=dict(modes),
                  predicted_launches=dict(predicted), weight_launches=dict(weight_modes),
                  top1=res['top1'], top5=res['top5'], loss=res['loss'],
                  images_per_sec=res['images_per_sec'], wall_s=wall)
    check(sum(modes.values()) > 0 and modes == predicted
          and launched_since(mark)['fake_quant'] == sum(predicted.values()),
          f'{arch} simulation: fake-quant launches {dict(modes)}, predicted {dict(predicted)}')
    check(np.isfinite([res['top1'], res['top5'], res['loss']]).all(),
          f'{arch} simulation: non-finite result {res}')
    return eng, params_q, qparams, summary, report


def zoo_serving(device, arch, size, batch):
    """W8A8 serving of one architecture: weight pass, serving preparation,
    scales frozen (max) on one batch, two frozen evaluation batches; the
    integer kernels' launches by route against the route table of the
    model's modules.  Returns (engine, prepared params, scales, report)."""
    model, meta = build_model(arch, device=device, seed=0, input_size=size)
    eng = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta)
    batches = list(synthetic_batches(batch, 3, size=size, seed=12345))
    per_forward = route_table(model)
    mark = counters.snapshot()
    t0 = time.perf_counter()
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))
    scales = eng.freeze_serving_scales(sp, batches[:1], max_batches=1, mode='max')
    res = evaluate(eng, sp, batches[1:], quantized='serving_int8', act_scales=scales)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launched = route_launches(mark)
    _, gemm_launches, conv_launches = kernel_launches(mark)
    predicted = times(per_forward, 3)   # one calibration forward, two evaluated
    kinds = Counter(kind for kind, _ in serving_launches(model))
    report = dict(gemm_per_forward=kinds['int8_gemm'], conv_per_forward=kinds['int8_conv'],
                  routes_per_forward=dict(per_forward), route_launches=dict(+launched),
                  predicted_route_launches=dict(predicted),
                  gemm_launches=gemm_launches, conv_launches=conv_launches,
                  frozen_sites=len(scales),
                  vector_scales=sum(1 for v in scales.values() if np.ndim(v) == 1),
                  top1=res['top1'], top5=res['top5'], loss=res['loss'],
                  images_per_sec=res['images_per_sec'], wall_s=wall)
    check(sum(per_forward.values()) > 0 and +launched == predicted
          and report['gemm_launches'] == 3 * kinds['int8_gemm']
          and report['conv_launches'] == 3 * kinds['int8_conv'],
          f'{arch} serving: routes launched {dict(+launched)}, predicted {dict(predicted)}')
    check(np.isfinite([res['top1'], res['top5'], res['loss']]).all(),
          f'{arch} serving: non-finite result {res}')
    return eng, sp, scales, report


def zoo_cli(device, size=224, extra=()):
    """VGG-16 mid-tread through the CLI: fake-quant launches by mode against
    the site table (mid-tread sites launch none), two batches.  ``extra``
    arguments follow ``ZOO_CLI`` (a later flag wins)."""
    arch = 'vgg16'
    model, _ = build_model(arch, device=device, seed=0, input_size=size)
    params = dict(model.state_dict())
    sites = discover_sites(model, (1, 3, size, size))
    policy = QuantPolicy(arch=arch, qtype='int4', qweight='int4', pcq_weights=True,
                         pcq_act=True, clipping='laplace', bit_alloc_act=True,
                         bit_alloc_weight=True, bias_corr_weight=True,
                         bit_alloc_target_act=5.3, bit_alloc_target_weight=5.3,
                         mtd_quant=True, measure_entropy=True)
    del model
    with tempfile.TemporaryDirectory() as home, contextlib.chdir(home), \
            mock.patch.dict(os.environ, {'HOME': home}):
        run = cli_run(ZOO_CLI + list(extra))
    predicted = predicted_weight_modes(policy, params) + times(
        predicted_site_modes(policy, sites), 2)
    res = run['res']
    report = dict(argv=' '.join(ZOO_CLI + list(extra)), launches=dict(run['modes']),
                  predicted_launches=dict(predicted), wall_s=run['wall_s'],
                  images_per_sec=res['images_per_sec'], top1=res['top1'], loss=res['loss'],
                  avg_entropy=res.get('avg_entropy'))
    check(run['modes'] == predicted and run['launches'] == sum(predicted.values()) > 0,
          f'vgg16 CLI: fake-quant launches {dict(run["modes"])}, predicted {dict(predicted)}')
    check(len(run['logits']) == 2 and all(bool(torch.isfinite(t).all()) for t in run['logits'])
          and 0.0 < res['avg_entropy'] <= 4.0, f'vgg16 CLI output: {report}')
    return report


def zoo_path(device, card, archs=ZOO_ARCHS, batch=ZOO_BATCH, sizes=None, held=4, cli=()):
    """The rest of the zoo at full width, each at its meta input size (299 for
    Inception-v3, else 224; ``sizes`` overrides), seeded weights, synthetic
    images, batch 32: the W4A4 headline simulation and W8A8 serving, each
    launch count against its prediction; every kernel call of one simulation
    and one serving forward of ``held`` images against the plain versions;
    VGG-16 mid-tread through the CLI (``cli``: extra arguments).  Returns the
    launches of each kernel."""
    report, launches = dict(batch=batch, archs={}), Counter()
    for arch in archs:
        size = (sizes or {}).get(arch) or (299 if arch == 'inception_v3' else 224)
        entry = report['archs'][arch] = dict(input_size=size)
        eng, pq, qparams, stats, entry['simulation'] = zoo_simulation(device, arch, size, batch)
        launches['fake_quant'] += sum(entry['simulation']['launches'].values())
        images = next(synthetic_batches(held, 1, size=size, seed=7))[0]
        entry['simulation_kernel_vs_plain'] = end_to_end_kernel_vs_plain(eng, pq, qparams,
                                                                         stats, images)
        del eng, pq, qparams, stats
        eng, sp, scales, entry['serving'] = zoo_serving(device, arch, size, batch)
        launches['int8_gemm'] += entry['serving']['gemm_launches']
        launches['int8_conv'] += entry['serving']['conv_launches']
        kernels_vs_plain_end_to_end(f'zoo_{arch}_serving_kernels_vs_plain_end_to_end', eng, sp,
                                    scales, images)
        del eng, sp, scales
    cli = report['vgg16_cli'] = zoo_cli(device, (sizes or {}).get('vgg16', 224), cli)
    launches['fake_quant'] += sum(cli['launches'].values())
    report['launches'] = dict(launches)
    emit('zoo_path', card=card, **report)
    return launches


# ---------------------------------------------------------------- slice 9: data, parallel, tools

DATA_IMAGES = 256


def write_npz_eval_set(path, n, size, seed=2024):
    """A preprocessed eval set as ``data/imagenet.make_loader`` reads it:
    ``images`` [n, size, size, 3] float32 (normalized, drawn like the
    synthetic batches) and ``labels`` [n]."""
    rng = np.random.RandomState(seed)
    images = np.empty((n, size, size, 3), np.float32)
    for i in range(0, n, 64):   # in chunks: no float64 copy of the whole set
        chunk = rng.rand(min(64, n - i), size, size, 3).astype(np.float32)
        images[i:i + len(chunk)] = (chunk - IMAGENET_MEAN) / IMAGENET_STD
    labels = rng.randint(0, 1000, n).astype(np.int32)
    np.savez(path, images=images, labels=labels)
    return os.path.getsize(path)


def data_path(device, card, arch='resnet50', size=224, batch=64, n_images=DATA_IMAGES):
    """The ImageNet loader's ``.npz`` route through the CLI: a preprocessed
    eval set of ``n_images`` seeded images, ``inference_sim --data <npz>``
    in process with the W4A4 headline recipe, ``-sm collect`` then ``-sm
    use``; every fake-quant launch by mode against the site table; top-1,
    top-5, loss and the logits of every batch equal to the same arrays fed to
    ``evaluate`` directly with the CLI's statistics; the class-folder route
    on a machine without PIL exits naming PIL and the ``.npz`` route."""
    from cnn_quantization_tpu_torch.cli import inference_sim
    from cnn_quantization_tpu_torch.data.imagenet import load_npz_batches
    model, meta = build_model(arch, device=device, seed=0)
    params = dict(model.state_dict())
    sites = discover_sites(model, (1, 3, size, size))
    policy = QuantPolicy(arch=arch, **HEADLINE)
    n_batches = -(-n_images // batch)
    report = dict(arch=arch, input_size=size, batch=batch, images=n_images, sites=len(sites))
    with tempfile.TemporaryDirectory() as home, contextlib.chdir(home), \
            mock.patch.dict(os.environ, {'HOME': home}):
        npz = os.path.join(home, 'val.npz')
        t0 = time.perf_counter()
        report['npz_bytes'] = write_npz_eval_set(npz, n_images, size)
        report['npz_write_s'] = time.perf_counter() - t0
        argv = ['-a', arch, '--input_size', str(size), '-b', str(batch), '--data', npz,
                '-pcq_w', '-pcq_a', '--qtype', 'int4', '-qw', 'int4', '-c', 'laplace',
                '-baa', '-baw', '-bcw']
        collect = cli_run(argv + ['-sm', 'collect'])
        # collect mode runs no weight pass: three error-column launches a site and batch
        predicted = Counter(affine=3 * len(sites) * n_batches)
        check(collect['modes'] == predicted and collect['launches'] == sum(predicted.values()),
              f'data_path collect: launches {dict(collect["modes"])}, predicted {dict(predicted)}')
        check(not any('using synthetic data' in ln for ln in collect['lines']),
              'data_path: the CLI fell back to synthetic data')
        use = cli_run(argv + ['-sm', 'use'])
        stats = load_stats(os.path.join(home, 'mxt-sim-tpu', 'statistics', 'per_channel',
                                        f'{arch}.npz'))
        engine = QuantEngine(model, policy, meta)
        qparams = engine.freeze_qparams(stats, input_shape=(1, size, size, 3))
        predicted_use = predicted_weight_modes(policy, params) + times(
            predicted_site_modes(policy, sites, stats, frozen=qparams), n_batches)
        check(use['modes'] == predicted_use and use['launches'] == sum(predicted_use.values())
              and len(qparams) == len(sites),
              f'data_path use: launches {dict(use["modes"])}, predicted {dict(predicted_use)}')
        # the same arrays through evaluate directly
        with cli_instrumented() as (_, logits):
            batches = load_npz_batches(npz, batch)
            direct = evaluate(engine, engine.quantize_params(params), batches, stats=stats,
                              qparams=qparams)
        res = use['res']
        same = (len(logits) == len(use['logits']) == n_batches
                and all(torch.equal(a, b) for a, b in zip(logits, use['logits'])))
        report.update(collect=dict(launches=dict(collect['modes']), wall_s=collect['wall_s']),
                      use=dict(launches=dict(use['modes']), wall_s=use['wall_s'],
                               images_per_sec=res['images_per_sec']),
                      top1=res['top1'], top5=res['top5'], loss=res['loss'],
                      direct=dict(top1=direct['top1'], top5=direct['top5'], loss=direct['loss']),
                      logits_equal_direct=same)
        check(same and all(res[k] == round(direct[k], 4) for k in ('top1', 'top5', 'loss'))
              and np.isfinite([res['top1'], res['top5'], res['loss']]).all(),
              f"data_path: CLI {res} against evaluate {direct}, logits equal {same}")
        # the class-folder route without PIL: one class folder, one file
        os.makedirs(os.path.join(home, 'tree', 'val', 'n01'))
        with open(os.path.join(home, 'tree', 'val', 'n01', 'a.png'), 'wb') as f:
            f.write(b'\x89PNG\r\n')
        with mock.patch.dict(sys.modules, {'PIL': None}):
            try:
                inference_sim.main(argv[:6] + ['--data', os.path.join(home, 'tree'), '-j', '2'])
                message = None
            except SystemExit as e:
                message = str(e)
        report['folder_without_pil_exit'] = message
        check(message is not None and 'PIL' in message and '.npz' in message,
              f'data_path: the class-folder route without PIL: {message}')
    report['launches'] = collect['launches'] + use['launches']
    emit('data_path', card=card, **report)
    return report


def serving_routes_from_params(model, params):
    """Launches by route of one plain serving forward, from the model's
    modules with the output channels of ``params`` (a rank's shard: a sliced
    conv computes its slice of outputs)."""
    table = Counter()
    for name, m in model.named_modules():
        if not isinstance(m, (QConv, QLinear)):
            continue
        w = params[f'{name}.weight']
        if isinstance(m, QLinear):
            table[im.gemm_route(w.shape[1])] += 1
        elif m.in_ch == 3 and w.dtype != torch.int8:
            continue   # the float stem
        elif (tuple(w.shape[2:]), m.strides, m.padding, m.groups) == ((1, 1), (1, 1), (0, 0), 1):
            table[im.gemm_route(m.in_ch)] += 1
        else:
            in_ch = w.shape[1] * m.groups
            table[ic.conv_route(in_ch, w.shape[0], m.groups, kernel=tuple(w.shape[2:]),
                                strides=m.strides if in_ch != 12 else (1, 1),
                                padding=m.padding if in_ch != 12 else (0, 0))] += 1
    return table


@contextlib.contextmanager
def route_calls():
    """Calls of the int8 wrappers by the route their shapes take (on the
    card each is one launch; on the CPU the plain versions run, and these
    calls stand in for the launches)."""
    calls = Counter()
    gemm, conv = im.int8_matmul_dequant, ic.int8_conv_dequant

    def gemm_call(a, b, *args, **kw):
        calls[im.gemm_route(a.shape[1])] += 1
        return gemm(a, b, *args, **kw)

    def conv_call(x, w, *args, strides=(1, 1), padding=(0, 0), groups=1, **kw):
        calls[ic.conv_route(x.shape[1], w.shape[0], groups, kernel=tuple(w.shape[2:]),
                            strides=tuple(strides), padding=tuple(padding))] += 1
        return conv(x, w, *args, strides=strides, padding=padding, groups=groups, **kw)

    with mock.patch.object(im, 'int8_matmul_dequant', gemm_call), \
            mock.patch.object(ic, 'int8_conv_dequant', conv_call):
        yield calls


PARALLEL_BATCHES = 2


def parallel_setup(device, arch, size, batch, s2d_stem):
    """The W8A8 serving set-up every run of ``parallel_path`` shares: seeded
    weights, prepared int8 params, scales frozen on one batch, and the
    evaluation batches."""
    model, meta = build_model(arch, device=device, seed=0)
    eng = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta)
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())),
                                    s2d_stem=s2d_stem)
    batches = list(synthetic_batches(batch, PARALLEL_BATCHES + 1, size=size, seed=99))
    scales = eng.freeze_serving_scales(sp, batches[:1], max_batches=1)
    return model, eng, sp, scales, batches[1:]


def parallel_worker(argv):
    """One rank of ``parallel_path`` (b): ``chip_smoke.py --parallel-worker
    <init> <world> <rank> <data> <model> <device> <arch> <size> <batch> <out>
    <checkpoint>``.  W8A8 serving with frozen scales on the (data, model)
    mesh of a gloo group, with the space-to-depth (all-integer) stem and with
    the float stem; writes the gathered logits, the counts and the int8
    launches by route (kernel counters and calls by shape).  With the s2d
    stem it also saves its shard of the serving tree into the DCP directory
    ``<checkpoint>`` (``save_params_sharded``, every rank together) and reads
    its slices back (``load_params_sharded`` with the mesh)."""
    from cnn_quantization_tpu_torch.parallel import make_mesh, shard_params
    from cnn_quantization_tpu_torch.parallel.distributed import init_distributed
    from cnn_quantization_tpu_torch.parallel.eval_parallel import evaluate_sharded
    from cnn_quantization_tpu_torch.utils.checkpoint import (load_params_sharded,
                                                             save_params_sharded)
    init, world, rank, data, model_axis, dev, arch, size, batch, out, ckpt = argv
    device = torch.device(dev)
    if device.type == 'cpu':
        torch.set_num_threads(1)
    init_distributed(init, int(world), int(rank), backend='gloo')
    mesh = make_mesh(data=int(data), model=int(model_axis))
    result = {}
    for stem, s2d in (('s2d_stem', True), ('float_stem', False)):
        model, eng, sp, scales, batches = parallel_setup(device, arch, int(size), int(batch),
                                                         s2d)
        mark = counters.snapshot()
        with route_calls() as calls:
            t0 = time.perf_counter()
            res = evaluate_sharded(eng, sp, batches, mesh=mesh, quantized='serving_int8',
                                   act_scales=scales, keep_logits=True)
            wall = time.perf_counter() - t0
        table = serving_routes_from_params(model, shard_params(sp, mesh, model))
        result[stem] = dict(top1=res['top1'], top5=res['top5'], loss=res['loss'],
                            logits=res['logits'].cpu().numpy(), wall_s=wall,
                            launches=dict(+route_launches(mark)), calls=dict(calls),
                            predicted=dict(times(table, len(batches))))
        if s2d:
            mine = shard_params(sp, mesh, model)
            t0 = time.perf_counter()
            save_params_sharded(ckpt, mine, mesh, model)
            save_s = time.perf_counter() - t0
            back = load_params_sharded(ckpt, mesh, model, device=device)
            result['checkpoint'] = dict(save_s=save_s, slices_equal=same_tree(back, mine))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(out, 'wb') as f:
        np.save(f, np.array(result, dtype=object), allow_pickle=True)


def same_tree(got, want):
    """Every entry of ``want`` in ``got`` and no other: equal dtype, shape,
    strides and values (bit for bit)."""
    return got.keys() == want.keys() and all(
        got[k].dtype == v.dtype and got[k].shape == v.shape and got[k].stride() == v.stride()
        and torch.equal(got[k], v) for k, v in want.items())


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def parallel_path(device, card, arch='resnet50', size=224, batch=64):
    """The parallel layer: (a) in process, a process group of one rank (NCCL
    on the card, gloo on the CPU) on a 1x1 mesh runs ``evaluate_sharded`` on
    the W4A4 frozen simulation and on W8A8 serving with frozen scales, and
    its counts and logits equal ``evaluate``'s bit for bit; (b) two
    processes over gloo on the one device, meshes data=2/model=1 and
    data=1/model=2, run W8A8 serving with frozen scales, and their gathered
    logits equal the single process's bit for bit with the space-to-depth
    stem (every conv integer; the float stem's cuDNN algorithm may change
    with the sliced shapes, so that variant is reported, not held), each
    rank's int8 launches by route equal to the route table of its sliced
    shapes.  Sharded parameter checkpoints (``utils/checkpoint.py``, DCP):
    in (a) the W8A8 serving tree saved and loaded into fresh tensors, every
    entry and the serving logits on it bit-equal; in (b) each mesh's ranks
    save their shards of the s2d-stem tree together, each reads its own
    slices back equal, and this process reads the checkpoint whole (equal to
    the unsharded tree) and by each model index (equal to ``shard_params``).
    No multi-GPU speed is measured: there is one card."""
    import subprocess
    import torch.distributed as dist
    from cnn_quantization_tpu_torch.parallel import Mesh, make_mesh, shard_params
    from cnn_quantization_tpu_torch.parallel.eval_parallel import evaluate_sharded
    from cnn_quantization_tpu_torch.utils.checkpoint import (load_params_sharded,
                                                             save_params_sharded)
    report = dict(arch=arch, input_size=size, batch=batch, batches=PARALLEL_BATCHES)
    launches = Counter()

    # (a) one rank, in process
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=f'tcp://127.0.0.1:{_free_port()}',
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        model, meta = build_model(arch, device=device, seed=0)
        params = dict(model.state_dict())
        eng = QuantEngine(model, QuantPolicy(arch=arch, **HEADLINE), meta)
        batches = list(synthetic_batches(batch, PARALLEL_BATCHES + 1, size=size, seed=98))
        pq = eng.quantize_params(params)
        stats = collect_statistics(eng.make_collect(), pq, batches[:1])
        qparams = eng.freeze_qparams(stats, input_shape=(1, size, size, 3))
        sites = discover_sites(model, (1, 3, size, size))
        runs = {}
        for name, run_eng, run_params, kw in (
                ('w4a4_frozen', eng, pq, dict(qparams=qparams)),
                ('w8a8_serving', None, None, None)):
            if run_eng is None:
                _, run_eng, run_params, scales, _ = parallel_setup(device, arch, size, batch, False)
                kw = dict(quantized='serving_int8', act_scales=scales)
            with cli_instrumented() as (_, single_logits):
                single = evaluate(run_eng, run_params, batches[1:], **kw)
            mark = counters.snapshot()
            t0 = time.perf_counter()
            sharded = evaluate_sharded(run_eng, run_params, batches[1:], mesh=mesh,
                                       keep_logits=True, **kw)
            wall = time.perf_counter() - t0
            counted = Counter(fake_quant=launched_since(mark)['fake_quant'],
                              **route_launches(mark))
            same = torch.equal(sharded['logits'], torch.cat(single_logits))
            runs[name] = dict(top1=sharded['top1'], top5=sharded['top5'], loss=sharded['loss'],
                              logits_equal=same, wall_s=wall,
                              images_per_sec=sharded['images_per_sec'], launches=dict(+counted))
            check(same and all(sharded[k] == single[k] for k in ('top1', 'top5', 'loss')),
                  f'parallel_path (a) {name}: sharded {runs[name]} against evaluate {single}')
            launches += counted
        # the serving tree through a DCP checkpoint: every entry and the
        # logits on the loaded tree bit-equal
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'w8a8_serving')
            t0 = time.perf_counter()
            save_params_sharded(path, run_params, mesh, model)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = load_params_sharded(path, mesh, model, device=device)
            load_s = time.perf_counter() - t0
            nbytes = dir_bytes(path)
        mark = counters.snapshot()
        fwd = run_eng.make_forward(quantized='serving_int8', act_scales=kw['act_scales'])
        before, _ = fwd(run_params, None, batches[1][0])
        after, _ = fwd(loaded, None, batches[1][0])
        launches += route_launches(mark)
        report['checkpoint_one_rank'] = ckpt = dict(
            entries=len(loaded), bytes_written=nbytes, save_s=save_s, load_s=load_s,
            entries_equal=same_tree(loaded, run_params),
            logits_equal=bool(torch.equal(before, after)))
        check(ckpt['entries_equal'] and ckpt['logits_equal'],
              f'parallel_path checkpoint round trip: {ckpt}')
        want_fq = len(sites) * PARALLEL_BATCHES
        want_int8 = times(route_table(model), PARALLEL_BATCHES)
        check(runs['w4a4_frozen']['launches'].get('fake_quant') == want_fq
              and Counter({k: v for k, v in runs['w8a8_serving']['launches'].items()})
              == want_int8, f'parallel_path (a) launches {runs}, predicted fake-quant '
              f'{want_fq}, int8 {dict(want_int8)}')
        report['one_rank'] = dict(backend=backend, **runs)
    finally:
        dist.destroy_process_group()
    del eng, pq, stats, qparams, model

    # (b) two processes over gloo on the one device
    single = {}
    for stem, s2d in (('s2d_stem', True), ('float_stem', False)):
        model8, eng8, sp, scales, eval_batches = parallel_setup(device, arch, size, batch, s2d)
        with cli_instrumented() as (_, logits):
            res = evaluate(eng8, sp, eval_batches, quantized='serving_int8', act_scales=scales)
        single[stem] = dict(res, logits=torch.cat(logits).cpu().numpy())
        if s2d:
            sp_s2d = sp
    del eng8, sp
    report['two_ranks'] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mesh_name, (data, model_axis) in (('data2_model1', (2, 1)),
                                               ('data1_model2', (1, 2))):
            init = f'tcp://127.0.0.1:{_free_port()}'
            outs = [os.path.join(tmp, f'{mesh_name}_{r}.npy') for r in range(2)]
            ckpt_dir = os.path.join(tmp, f'{mesh_name}_checkpoint')
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--parallel-worker', init, '2',
                 str(r), str(data), str(model_axis), str(device), arch, str(size), str(batch),
                 outs[r], ckpt_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
            try:
                for p in procs:
                    _, err = p.communicate(timeout=600)
                    check(p.returncode == 0, f'parallel_path rank failed:\n{err[-3000:]}')
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            wall = time.perf_counter() - t0
            entry = report['two_ranks'][mesh_name] = dict(wall_s_both_ranks=wall)
            # the ranks' checkpoint holds the unsharded tree once: read whole
            # it equals the tree, read by a mesh index it equals that slice
            t0 = time.perf_counter()
            whole = load_params_sharded(ckpt_dir, device=device)
            ck = entry['checkpoint'] = dict(
                bytes_written=dir_bytes(ckpt_dir), load_whole_s=time.perf_counter() - t0,
                whole_equal=same_tree(whole, sp_s2d), slices_equal=[
                    same_tree(load_params_sharded(ckpt_dir, m, model8, device=device),
                              shard_params(sp_s2d, m, model8))
                    for m in (Mesh(data, model_axis, 0, i) for i in range(model_axis))])
            del whole
            for r, path in enumerate(outs):
                got = np.load(path, allow_pickle=True).item()
                rank_ck = got.pop('checkpoint')
                ck[f'rank{r}'] = rank_ck
                check(rank_ck['slices_equal'], f'parallel_path {mesh_name} rank {r}: the '
                      f'slices read back differ from its shard ({rank_ck})')
                for stem, g in got.items():
                    want = single[stem]
                    equal = bool(np.array_equal(g['logits'], want['logits']))
                    counted = g['launches'] if device.type == 'cuda' else g['calls']
                    rank_entry = dict(
                        logits_equal=equal, top1=g['top1'], top5=g['top5'], loss=g['loss'],
                        wall_s=g['wall_s'], launches=counted, predicted=g['predicted'],
                        max_abs_logit_diff=float(np.abs(g['logits'] - want['logits']).max()))
                    entry[f'rank{r}_{stem}'] = rank_entry
                    check(counted == g['predicted'] and sum(counted.values()) > 0,
                          f'parallel_path {mesh_name} rank {r} {stem}: launches {counted}, '
                          f"the sliced route table predicts {g['predicted']}")
                    if stem == 's2d_stem':
                        check(equal and all(g[k] == want[k] for k in ('top1', 'top5')),
                              f'parallel_path {mesh_name} rank {r}: {rank_entry} against '
                              f"the single process's {want['top1']}, {want['top5']}")
                    if device.type == 'cuda':
                        launches.update(g['launches'])
            check(ck['whole_equal'] and all(ck['slices_equal']),
                  f'parallel_path {mesh_name} checkpoint: {ck}')
    report['launches'] = dict(launches)
    emit('parallel_path', card=card, **report)
    return report


def tools_path(device, card, arch='resnet50', golden_size=224, golden_batch=64,
               ste_shape=STAGE1_ACT):
    """The auxiliary tools at full width: (1) k-means of ResNet-50's weights
    to 4 bits, ``quantize`` and ``clip``, with and without bias correction
    (seconds, inertia, distinct values per leaf, at most 16 without the
    correction), the CLI's ``.npz`` read back through ``inference_sim
    --weights``; (2) ``golden_repro --smoke`` (all six configs) and its
    ``w4a4_headline`` at ``golden_size`` and batch ``golden_batch`` on
    synthetic data, fake-quant launches counted; (3) ``fake_quant_ste`` at
    ``ste_shape`` per channel: forward equal to the plain version, gradient
    equal to the plain clamp mask; (4) ``cost_analysis`` of one W8A8 serving
    forward at ``golden_size`` and batch ``golden_batch``, its operations
    equal to ``count_work``'s, its bytes beside that count's."""
    from cnn_quantization_tpu_torch.cli import golden_repro
    from cnn_quantization_tpu_torch.cli import kmeans_quantization as km
    from cnn_quantization_tpu_torch.ops.ste import fake_quant_ste, fake_quant_ste_mask
    from cnn_quantization_tpu_torch.utils.checkpoint import load_params_npz
    from cnn_quantization_tpu_torch.utils.flax_params import state_dict_from_flax
    report = dict(arch=arch)
    launches = Counter()
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == 'cuda' else (lambda: None)

    # (1) the k-means CLI, both tasks, each with and without bias correction
    kmeans = {}
    with tempfile.TemporaryDirectory() as home, contextlib.chdir(home), \
            mock.patch.dict(os.environ, {'HOME': home}):
        dev_args = ['--device', 'cpu'] if device.type == 'cpu' else []
        for task in ('quantize', 'clip'):
            with contextlib.redirect_stdout(io.StringIO()):
                # one directory a task: both name their file <arch>_kmeans4bit.npz
                out = km.run(km.build_parser().parse_args(
                    ['-a', arch, '-bits', '4', '-t', task, '--out_dir', os.path.join(home, task)]
                    + dev_args))
            for key, r in out.items():
                entry = kmeans[task + ('_bcorr' if key == 'bcorr' else '')] = dict(
                    seconds=r['seconds'], leaves=len(r['inertia']),
                    inertia=sum(r['inertia'].values()))
                if task == 'quantize' and key == 'plain':
                    distinct = {k: int(torch.unique(r['params'][k]).numel())
                                for k in r['inertia']}
                    entry.update(max_distinct_per_leaf=max(distinct.values()),
                                 min_distinct_per_leaf=min(distinct.values()))
                    check(len(distinct) > 0 and max(distinct.values()) <= 16,
                          f'k-means: distinct values per leaf {distinct}')
                    quantized, path = r['params'], r['path']
        report['kmeans'] = kmeans
        saved = state_dict_from_flax(load_params_npz(path), arch)
        check(all(torch.equal(saved[k], quantized[k].cpu()) for k in saved),
              'k-means CLI: the saved .npz differs from what it quantized')
        del quantized
        run = cli_run(['-a', arch, '-b', '8', '--subset', '8', '--qtype', 'int8', '-qw', 'int8',
                       '--weights', path, '--input_size', str(golden_size)])
        check(not any('random init' in ln for ln in run['lines'])
              and np.isfinite(run['res']['loss']), 'k-means .npz through --weights')
        report['kmeans_weights_run'] = dict(wall_s=run['wall_s'], loss=run['res']['loss'],
                                            launches=dict(run['modes']))
        launches['fake_quant'] += run['launches']

        # (2) the golden runbook
        golden = {}
        for name, argv in (('smoke', ['--smoke']),
                           ('w4a4_headline', ['--only', 'w4a4_headline', '-b', str(golden_batch),
                                              '--input_size', str(golden_size),
                                              '--subset', str(golden_batch)])):
            out = os.path.join(home, f'golden_{name}.json')
            mark = counters.snapshot()
            with cli_instrumented() as (modes, logits), \
                    contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                rc = golden_repro.main(argv + dev_args + ['--out', out])
                sync()
                wall = time.perf_counter() - t0
            with open(out) as f:
                rows = json.load(f)
            fq_launches = launched_since(mark)['fake_quant']
            golden[name] = dict(rc=rc, wall_s=wall, configs=[r['config'] for r in rows],
                                launches=dict(modes), forwards=len(logits),
                                rows=[{k: r[k] for k in ('config', 'top1', 'top5', 'verdict')}
                                      for r in rows])
            check(rc == 0 and all(np.isfinite([r['top1'], r['top5']]).all() for r in rows)
                  and sum(modes.values()) == fq_launches > 0
                  and all(bool(torch.isfinite(t).all()) for t in logits),
                  f'golden_repro {name}: {golden[name]}')
            launches['fake_quant'] += fq_launches
        check(golden['smoke']['configs'] == [g[0] for g in golden_repro.GOLDEN],
              f"golden smoke ran {golden['smoke']['configs']}")
        report['golden'] = golden

    # (3) the STE at the stage-1 shape, per channel
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(ste_shape, generator=gen).to(device) \
        .contiguous(memory_format=torch.channels_last)
    delta, offset, qmax = per_channel_params(x, 1, gen)
    x.requires_grad_(True)
    grad_out = torch.randn(ste_shape, generator=gen).to(device) \
        .contiguous(memory_format=torch.channels_last)
    mark = counters.snapshot()
    out = fake_quant_ste(x, delta, offset, qmax, channel_dim=1)
    out.backward(grad_out)
    ste_launches = launched_since(mark)['fake_quant']
    want = fq.fake_quant_fused_plain(x.detach(), delta, offset, qmax, channel_dim=1)
    mask = fake_quant_ste_mask(x.detach(), delta, offset, channel_dim=1)
    fwd_err = float((out.detach() - want).abs().max())
    grad_equal = bool(torch.equal(x.grad, mask * grad_out))
    xd = x.detach()
    report['ste'] = dict(
        shape=list(ste_shape), launches=ste_launches, forward_max_abs_err=fwd_err,
        grad_equal_plain_mask=grad_equal, inside_share=float(mask.mean()),
        forward_ms=cuda_ms(lambda: fake_quant_ste(xd, delta, offset, qmax, channel_dim=1))
        if device.type == 'cuda' else None)
    check(fwd_err == 0.0 and grad_equal and 0.0 < float(mask.mean()) < 1.0
          and ste_launches == 1,
          f"fake_quant_ste: {report['ste']}")
    launches['fake_quant'] += ste_launches

    # (4) cost_analysis of one W8A8 serving forward beside count_work's count
    model, eng8, sp, scales, batches = parallel_setup(device, arch, golden_size, golden_batch,
                                                      False)
    # both count what the forward's modules and wrappers do: run them
    fwd = eng8.make_forward(quantized='serving_int8', act_scales=scales).eager
    images = batches[0][0]
    mark = counters.snapshot()
    t0 = time.perf_counter()
    cost = cost_analysis(fwd, sp, None, images)
    sync()
    cost_s = time.perf_counter() - t0
    ops, nbytes = count_work(model, lambda: fwd(sp, None, images))
    report['cost_analysis'] = cost_rep = dict(
        batch=golden_batch, input_size=golden_size, flops=cost['flops'],
        bytes_accessed=cost['bytes accessed'], count_work_ops=ops, count_work_bytes=nbytes,
        seconds=cost_s, launches=dict(+route_launches(mark)),
        predicted=dict(times(route_table(model), 2)))
    check(cost['flops'] == ops > 0 and cost_rep['launches'] == cost_rep['predicted'],
          f'cost_analysis against count_work: {cost_rep}')
    launches += route_launches(mark)
    report['launches'] = dict(launches)
    emit('tools_path', card=card, **report)
    return report


class HostReads(TorchDispatchMode):
    """While active, counts the host's reads of tensor values: scalar reads
    (``item``, ``float``, ``bool``: ``aten._local_scalar_dense``) and
    copies from a CUDA tensor to the CPU."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        elif any(isinstance(t, torch.Tensor) and t.device.type == 'cuda'
                 for t in tree_leaves((args, kwargs))) \
                and any(isinstance(t, torch.Tensor) and t.device.type == 'cpu'
                        for t in tree_leaves(out)):
            self.reads += 1
        return out


class Preempted(Exception):
    pass


def preemptible(batches, reads, fail_at=None):
    """(loader, marks): the batches from the host; ``marks`` gets
    ``reads.reads`` at every request, the one that ends the loop included, so
    ``marks[-1] - marks[0]`` is what the loop read; asked for batch
    ``fail_at`` the loader raises ``Preempted``."""
    marks = []

    def gen():
        for i, b in enumerate(batches):
            marks.append(reads.reads)
            if i == fail_at:
                raise Preempted(f'batch {i}')
            yield b
        marks.append(reads.reads)
    return gen(), marks


RESUME_BATCHES, RESUME_FAIL_AT, RESUME_EVERY = 6, 3, 2


def resume_path(device, card, arch='resnet50', size=224, batch=64):
    """Eval-loop checkpoint/resume (``evaluate(resume_path=,
    checkpoint_every=)``) under two recipes, the W4A4 headline with frozen
    qparams (the fake-quant kernel at every site) and W8A8 serving with
    frozen scales (the int8 GEMM and conv): ``RESUME_BATCHES`` seeded batches
    from the host, each recipe run three times, every kernel's launches counted
    per run: uninterrupted (no file, no read of a device value inside the loop);
    interrupted, its loader raising when asked for batch ``RESUME_FAIL_AT``
    with a checkpoint every ``RESUME_EVERY`` batches (the file then holds the
    batches before the last checkpoint; the loop reads the four device sums
    once a checkpoint); resumed from that file (top-1/top-5 equal to the
    uninterrupted run's, the loss within 1e-6 relative, the file removed,
    launches for the batches it ran and none for those it skipped).  The host
    reads are counted in the first two runs only; the third is timed bare."""
    model, meta = build_model(arch, device=device, seed=0)
    params = dict(model.state_dict())
    calib, *batches = synthetic_batches(batch, RESUME_BATCHES + 1, size=size, seed=4242)
    sites = discover_sites(model, (1, 3, size, size))
    _, gemm_per, conv_per = launch_table(model)
    eng = QuantEngine(model, QuantPolicy(arch=arch, **HEADLINE), meta)
    pq = eng.quantize_params(params)
    stats = collect_statistics(eng.make_collect(), pq, [calib])
    qparams = eng.freeze_qparams(stats, input_shape=(1, size, size, 3))
    eng8 = QuantEngine(model, QuantPolicy(arch=arch, **W8A8), meta)
    sp = eng8.prepare_serving_params(eng8.quantize_params(params))
    scales = eng8.freeze_serving_scales(sp, [calib], max_batches=1)
    recipes = {
        'w4a4_frozen': (eng, pq, dict(stats=stats, qparams=qparams),
                        Counter(fake_quant=len(sites))),
        'w8a8_serving': (eng8, sp, dict(quantized='serving_int8', act_scales=scales),
                         Counter(int8_gemm=gemm_per, int8_conv=conv_per))}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == 'cuda' else (lambda: None)
    ran = {'uninterrupted': RESUME_BATCHES, 'interrupted': RESUME_FAIL_AT,
           'resumed': RESUME_BATCHES - RESUME_FAIL_AT // RESUME_EVERY * RESUME_EVERY}
    report = dict(arch=arch, input_size=size, batch=batch, batches=RESUME_BATCHES,
                  fail_at=RESUME_FAIL_AT, checkpoint_every=RESUME_EVERY)
    launches = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name, (e, p, kw, per_forward) in recipes.items():
            path = os.path.join(tmp, f'{name}.json')
            runs = {}
            for run in ('uninterrupted', 'interrupted', 'resumed'):
                reads = HostReads()
                loader, marks = preemptible(batches, reads,
                                            RESUME_FAIL_AT if run == 'interrupted' else None)
                mark = counters.snapshot()
                res = None
                t0 = time.perf_counter()
                with reads if run != 'resumed' else contextlib.nullcontext():
                    try:
                        res = evaluate(e, p, loader, **kw, checkpoint_every=RESUME_EVERY,
                                       resume_path=None if run == 'uninterrupted' else path)
                    except Preempted:
                        pass
                sync()
                counted = launched_since(mark)
                runs[run] = entry = dict(wall_s=time.perf_counter() - t0,
                                         launches=dict(+counted), file_left=os.path.exists(path),
                                         predicted=dict(times(per_forward, ran[run])))
                if run != 'resumed':
                    entry['reads_in_loop'] = marks[-1] - marks[0]
                if res is not None:
                    entry.update(top1=res['top1'], top5=res['top5'], loss=res['loss'],
                                 images_per_sec=res['images_per_sec'])
                if run == 'interrupted' and entry['file_left']:
                    with open(path) as f:
                        entry['file'] = json.load(f)
                launches += counted
            full, cut, resumed = runs['uninterrupted'], runs['interrupted'], runs['resumed']
            report[name] = runs
            checkpointed = RESUME_FAIL_AT // RESUME_EVERY * RESUME_EVERY
            check(all(r['launches'] == r['predicted'] for r in runs.values())
                  and full['reads_in_loop'] == 0 and not full['file_left']
                  and 'top1' not in cut and cut.get('file', {}).get('batches') == checkpointed
                  and cut['file']['seen'] == checkpointed * batch
                  and cut['reads_in_loop'] == 4 * (RESUME_FAIL_AT // RESUME_EVERY)
                  and not resumed['file_left'],
                  f'resume_path {name}: {runs}')
            check(resumed['top1'] == full['top1'] and resumed['top5'] == full['top5']
                  and abs(resumed['loss'] - full['loss']) <= 1e-6 * abs(full['loss']),
                  f"resume_path {name}: resumed {resumed} against uninterrupted {full}")
    report['launches'] = dict(launches)
    emit('resume_path', card=card, **report)
    return report


# ---------------------------------------------------------------- slice 11: accuracy ordering

# the JAX package's tests/test_accuracy_ordering.py, copied: its task, its
# training recipe, its six golden configurations and its thresholds
ORDERING_ARCH, ORDERING_SIZE = 'resnet18', 32
ORDERING_CONFIGS = {
    'fp32': ['--q_off'],
    'w8a8': ['--qtype', 'int8', '-qw', 'int8'],
    'naive_w4a4': ['-pcq_w', '-pcq_a', '--qtype', 'int4', '-qw', 'int4'],
    'headline': ['-pcq_w', '-pcq_a', '--qtype', 'int4', '-qw', 'int4',
                 '-c', 'laplace', '-baa', '-baw', '-bcw'],
    '2std': ['--qtype', 'int4', '-qw', 'int8', '-c', '2std'],
    'w8a8_serving': ['--qtype', 'int8', '-qw', 'int8', '--serving_int8'],
}
# the top-1 points within which the card and the CPU must agree: 4 of 2048
# images (the integer sums are exact; a float-stem rounding tie can move an
# argmax)
CARD_VS_CPU_TOP1 = 0.2


def smooth_prototypes(rs, n, size, ch):
    """Random smooth class prototypes via low-frequency Fourier synthesis."""
    k = 6
    coeff = rs.randn(n, k, k, ch) + 1j * rs.randn(n, k, k, ch)
    spec = np.zeros((n, size, size, ch), np.complex64)
    spec[:, :k, :k, :] = coeff
    img = np.fft.ifft2(spec, axes=(1, 2)).real.astype(np.float32)
    img /= img.std(axis=(1, 2, 3), keepdims=True) + 1e-8
    return img


def make_dataset(seed=0, n_classes=100, n_train=4000, n_test=2048, amp=0.25, size=32):
    """The ordering task, ((x_train, y_train), (x_test, y_test)), NHWC float32
    images and int32 labels, bit for bit the JAX ordering test's: a low-SNR
    matched filter (x = amp * prototype[class] + noise) with per-sample gain
    jitter and 0.5 % outlier pixels at +-8 (heavy tails)."""
    rs = np.random.RandomState(seed)
    protos = smooth_prototypes(rs, n_classes, size, 3)

    def draw(n, seed2):
        r2 = np.random.RandomState(seed2)
        y = r2.randint(0, n_classes, n).astype(np.int32)
        x = amp * protos[y] + r2.randn(n, size, size, 3).astype(np.float32)
        gain = np.exp(0.5 * r2.randn(n, 1, 1, 1)).astype(np.float32)
        x = x * gain
        mask = r2.rand(*x.shape) < 0.005  # outlier pixels (heavy tails)
        x = np.where(mask, 8.0 * np.sign(r2.randn(*x.shape)).astype(np.float32), x)
        return x.astype(np.float32), y

    return draw(n_train, seed + 1), draw(n_test, seed + 2)


def train_ordering_net(device, steps=1000, batch=128, lr=1e-3, seed=0, init=None):
    """The JAX ordering test's ``_train`` on the port: the registry's
    ResNet-18 (BN folded: no BN layer, 1000-way head), seeded truncated
    He-normal init (or the state dict ``init``), Adam (0.9, 0.999, 1e-8),
    mean softmax cross-entropy on the float path in float32 (no TF32), batch
    indices from ``RandomState(seed)``.  The module is trained directly, with
    autograd through cuDNN/cuBLAS.  Returns (model, meta, (x_test, y_test),
    report)."""
    import torch.nn.functional as F
    from cnn_quantization_tpu_torch.engine.context import TapContext
    (xtr, ytr), test = make_dataset(seed)
    model, meta = build_model(ORDERING_ARCH, device=device, seed=seed)
    if init is not None:
        model.load_state_dict(init)
    images = torch.as_tensor(xtr, device=device)
    labels = torch.as_tensor(ytr, dtype=torch.long, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rs = np.random.RandomState(seed)
    losses = torch.empty(steps, device=device)
    t0 = time.perf_counter()
    for i in range(steps):
        idx = torch.as_tensor(rs.randint(0, len(xtr), batch), device=device)
        logits = model(images[idx].permute(0, 3, 1, 2), TapContext())
        loss = F.cross_entropy(logits, labels[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    report = dict(steps=steps, batch=batch, lr=lr, seed=seed,
                  train_s=time.perf_counter() - t0,
                  first_loss=float(losses[0]), last10_loss=float(losses[-10:].mean()))
    return model.eval(), meta, test, report


def ordering_predictions(model, params, policy, serving, n_batches, cal_batches):
    """(fake-quant launches by mode, integer launches by route) of one CLI
    run of the ordering task: the weight pass, then per evaluated batch the
    dynamic sites by their quantizer's branch; on the serving path instead
    one integer forward per calibration and per evaluated batch."""
    if policy.qtype is None:
        return Counter(), Counter()
    modes = predicted_weight_modes(policy, params)
    if serving:
        return modes, times(route_table(model), cal_batches + n_batches)
    sites = discover_sites(model, (1, 3, ORDERING_SIZE, ORDERING_SIZE))
    return modes + times(predicted_site_modes(policy, sites), n_batches), Counter()


def accuracy_path(device, card, steps=1000, n_test=2048, batch=256, draws=16):
    """The recipes' accuracy ordering on a network the port trained: the JAX
    ordering test's ResNet-18 trained on the card (``train_ordering_net``),
    its weights written as the JAX package's ``.npz`` and its test set as
    ``images``/``labels``, then the six golden configurations through
    ``inference_sim`` on the card, each in a HOME and working directory of
    its own: top-1, top-5, loss, wall seconds and images/s; the fake-quant
    launches by mode and the integer launches by route against the site and
    route tables.  Then one batch of the trained network through the kernels
    and their plain versions (the headline's dynamic simulation; W8A8 serving
    with the CLI's frozen scales); the float-order band of the three 4-bit
    recipes through the kernels (``accuracy_band``, ``draws`` one-ulp
    nudges of the trained weights; its launches by mode against the tables),
    and in how many draws each of the six ordering assertions holds with the
    draw's 4-bit top-1s; and ``fp32``, ``w8a8_serving`` and the three 4-bit
    recipes once more on the CPU from the same files.  The ordering itself
    and the CPU runs against the card are checked by ``main``.  Returns the
    report."""
    from cnn_quantization_tpu_torch.utils.checkpoint import save_params_npz
    from cnn_quantization_tpu_torch.utils.flax_params import flax_from_state_dict
    # deterministic cuDNN algorithms: the same trained network run after run
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    model, meta, (xte, yte), train = train_ordering_net(device, steps=steps)
    xte, yte = xte[:n_test], yte[:n_test]
    params = {k: v.detach() for k, v in model.state_dict().items()}
    n_batches = -(-n_test // batch)
    cal_batches = min(n_batches, 4)   # freeze_serving_scales' max_batches
    report = dict(arch=ORDERING_ARCH, input_size=ORDERING_SIZE, eval_batch=batch,
                  images=n_test, train=train, configs={}, cpu={})
    launches = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        wpath, dpath = os.path.join(tmp, 'resnet18_syn.npz'), os.path.join(tmp, 'eval.npz')
        save_params_npz(wpath, flax_from_state_dict(params, ORDERING_ARCH))
        np.savez(dpath, images=xte, labels=yte)
        base = ['-a', ORDERING_ARCH, '-b', str(batch), '--data', dpath, '--weights', wpath]

        def run_cli(name, dev):
            with tempfile.TemporaryDirectory(dir=tmp) as home, contextlib.chdir(home), \
                    mock.patch.dict(os.environ, {'HOME': home}):
                run = cli_run(base + ORDERING_CONFIGS[name] + ['--device', dev])
            res = run['res']
            entry = dict(top1=res['top1'], top5=res['top5'], loss=res['loss'],
                         wall_s=run['wall_s'], images_per_sec=res['images_per_sec'])
            check(not any('random init' in ln for ln in run['lines'])
                  and np.isfinite([res['top1'], res['top5'], res['loss']]).all(),
                  f'accuracy_path {name} on {dev}: {entry}')
            return entry, run

        for name, flags in ORDERING_CONFIGS.items():
            mark = counters.snapshot()
            entry, run = run_cli(name, device.type)
            counted = launched_since(mark)
            routes = +route_launches(mark)
            policy = ordering_policy(name)
            modes, route_pred = ordering_predictions(model, params, policy,
                                                     '--serving_int8' in flags, n_batches,
                                                     cal_batches)
            entry.update(launches=dict(+counted), fake_quant_modes=dict(run['modes']),
                         predicted_fake_quant_modes=dict(modes), routes=dict(routes),
                         predicted_routes=dict(route_pred))
            report['configs'][name] = entry
            check(run['modes'] == modes and counted['fake_quant'] == sum(modes.values())
                  and routes == route_pred
                  and counted['int8_gemm'] + counted['int8_conv'] == sum(route_pred.values())
                  and (policy.qtype is None) == (sum(counted.values()) == 0),
                  f'accuracy_path {name}: launches {entry}')
            launches += counted

        # one batch of the trained network through the kernels and their
        # plain versions
        images = xte[:batch]
        eng = QuantEngine(model, QuantPolicy(arch=ORDERING_ARCH, **HEADLINE), meta)
        report['headline_kernel_vs_plain'] = end_to_end_kernel_vs_plain(
            eng, eng.quantize_params(params), None, None, images)
        eng8 = QuantEngine(model, QuantPolicy(arch=ORDERING_ARCH, **W8A8), meta)
        sp = eng8.prepare_serving_params(eng8.quantize_params(params))
        scales = eng8.freeze_serving_scales(
            sp, [(xte[i:i + batch], yte[i:i + batch]) for i in range(0, n_test, batch)])
        report['serving_kernel_vs_plain'] = kernels_vs_plain_end_to_end(
            'accuracy_serving_kernels_vs_plain_end_to_end', eng8, sp, scales, images)
        del eng, eng8, sp

        # the float-order band of the 4-bit recipes, through the kernels
        t_band = time.perf_counter()
        state = {k: v.cpu().numpy() for k, v in params.items()}
        score = port_band_scorer(model, meta, xte, yte, batch, device)
        mark = counters.snapshot()
        with cli_instrumented() as (modes, logits):
            def score_keeping_no_logits(state, name):
                out = score(state, name)
                logits.clear()
                return out
            band = accuracy_band(score_keeping_no_logits, state, draws)
        counted_band = launched_since(mark)
        predicted = Counter()
        for name in BAND_CONFIGS:
            one, _ = ordering_predictions(model, params, ordering_policy(name), False,
                                          n_batches, cal_batches)
            predicted += times(one, draws + 1)
        check(modes == predicted and +counted_band == Counter(fake_quant=sum(predicted.values()))
              and not +route_launches(mark),
              f'accuracy_path band: launches {dict(counted_band)} by mode {dict(modes)}, the '
              f'tables predict {dict(predicted)}')
        launches += counted_band
        top1 = {name: c['top1'] for name, c in report['configs'].items()}
        held = Counter()
        for k in range(draws):
            for rule, ok in ordering_holds(
                    {**top1, **{n: band[n]['top1']['draws'][k] for n in BAND_CONFIGS}}).items():
                held[rule] += ok
        report['band'] = dict(draws=draws, share=BAND_SHARE, configs=band,
                              launches=dict(+counted_band), fake_quant_modes=dict(modes),
                              ordering_held_in_draws={r: held[r] for r in ordering_holds(top1)},
                              wall_s=time.perf_counter() - t_band)

        # the card against the CPU, from the same files
        for name in ('fp32', 'w8a8_serving') + BAND_CONFIGS:
            report['cpu'][name], _ = run_cli(name, 'cpu')
    report.update(launches=dict(launches), wall_s=time.perf_counter() - t0)
    emit('accuracy_path', card=card, **report)
    return report


def ordering_holds(top1):
    """The JAX ordering test's six assertions on the six configs' top-1
    (tests/test_accuracy_ordering.py): {assertion: holds}."""
    return {
        'fp32 > 70': top1['fp32'] > 70.0,
        'w8a8 > fp32 - 2': top1['w8a8'] > top1['fp32'] - 2.0,
        'w8a8_serving > w8a8 - 1.5': top1['w8a8_serving'] > top1['w8a8'] - 1.5,
        'headline > naive_w4a4': top1['headline'] > top1['naive_w4a4'],
        'naive_w4a4 > 2std + 2': top1['naive_w4a4'] > top1['2std'] + 2.0,
        'naive_w4a4 < fp32 - 3': top1['naive_w4a4'] < top1['fp32'] - 3.0,
    }


# ------------------------------------------------------------ the 4-bit recipes' float-order band

# the 4-bit recipes, whose top-1 moves with the last bit of a float sum; a
# draw of the band nudges this share of every weight tensor's elements up by
# one ulp
BAND_CONFIGS = ('naive_w4a4', 'headline', '2std')
BAND_SHARE = 0.3


def nudge_weights(state, draw, share=BAND_SHARE):
    """Draw ``draw`` of the float-order band: a copy of the state dict (name ->
    array, the port's layout) with ``share`` of each weight tensor's elements
    (ndim >= 2), chosen by ``RandomState(draw)`` in name order, moved up by
    one ulp (``np.nextafter`` toward +inf).  Biases stay as they are.  Arrays
    come back as C-contiguous float32 numpy."""
    rs = np.random.RandomState(draw)
    out = {}
    for name in sorted(state):
        w = np.array(state[name], dtype=np.float32, order='C')
        if w.ndim >= 2:
            flat = w.reshape(-1)
            idx = rs.choice(flat.size, int(share * flat.size), replace=False)
            flat[idx] = np.nextafter(flat[idx], np.float32(np.inf))
        out[name] = w
    return out


def band_summary(values):
    """mean, sample sd, min and max of a list of top-1s, and the list."""
    v = np.asarray(values, np.float64)
    return dict(mean=float(v.mean()), sd=float(v.std(ddof=1)), min=float(v.min()),
                max=float(v.max()), draws=[float(x) for x in v])


def accuracy_band(score, state, draws, configs=BAND_CONFIGS):
    """The float-order band of each config: ``score(state, name) -> (top1,
    top5)`` on the unperturbed state and on ``draws`` draws of
    ``nudge_weights``.  Returns {name: {'unperturbed': top1,
    'unperturbed_top5', 'top1': band_summary, 'top5': band_summary}}."""
    out = {}
    for name in configs:
        t1, t5 = score(state, name)
        out[name] = dict(unperturbed=t1, unperturbed_top5=t5, top1=[], top5=[])
    for k in range(draws):
        nudged = nudge_weights(state, k)
        for name in configs:
            t1, t5 = score(nudged, name)
            out[name]['top1'].append(t1)
            out[name]['top5'].append(t5)
    for entry in out.values():
        entry['top1'], entry['top5'] = band_summary(entry['top1']), band_summary(entry['top5'])
    return out


def ordering_policy(name, arch=ORDERING_ARCH):
    """The port's policy of one golden configuration, as ``inference_sim``
    builds it from its flags."""
    from cnn_quantization_tpu_torch.cli import inference_sim
    args = inference_sim.build_parser().parse_args(['-a', arch] + ORDERING_CONFIGS[name])
    return (QuantPolicy(qtype=None, arch=arch) if args.q_off
            else inference_sim.policy_from_args(args))


def port_band_scorer(model, meta, images, labels, batch, device):
    """``score`` of ``accuracy_band`` on the port: the weight pass, then
    ``evaluate`` (dynamic statistics, as the CLI runs these configs) over
    ``images``/``labels`` at ``batch`` on ``device``."""
    batches = [(images[i:i + batch], labels[i:i + batch]) for i in range(0, len(images), batch)]
    engines = {}

    def score(state, name):
        if name not in engines:
            engines[name] = QuantEngine(model, ordering_policy(name), meta)
        eng = engines[name]
        params = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                  for k, v in state.items()}
        res = evaluate(eng, eng.quantize_params(params), batches)
        return res['top1'], res['top5']

    return score


def band_holds(band, top1, n_images, sds=4.0, floor_images=4):
    """Whether ``top1`` lies within the band's mean +- max(sds * sd,
    floor_images images), and that half-width."""
    half = max(sds * band['sd'], 100.0 * floor_images / n_images)
    return abs(top1 - band['mean']) <= half, half


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
    int4_err = int4_kernel_vs_plain(device)
    copy_worst = stream_copy_vs_plain(device)
    im2col_vs_implicit(device)
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

    # ---- main path 1, the rest of the CLI: KLD, mid-tread, stochastic, the sweeps
    cli = cli_path(device, card)

    # ---- the rest of the zoo: W4A4 simulation and W8A8 serving of eight architectures
    zoo = zoo_path(device, card)

    # ---- slice 9: the ImageNet loader's .npz route, the tools, the parallel layer
    data = data_path(device, card)
    tools = tools_path(device, card)
    par = parallel_path(device, card)

    # ---- slice 10: eval-loop resume (the checkpoints and cost_analysis ride
    # in parallel_path and tools_path)
    resume = resume_path(device, card)
    check(resume['w4a4_frozen']['resumed']['predicted'] == {'fake_quant': 56 * 4}
          and resume['w8a8_serving']['resumed']['predicted']
          == {'int8_gemm': 34 * 4, 'int8_conv': 19 * 4},
          f'resume_path per-forward tables: {resume}')

    # ---- slice 11: the recipes' accuracy ordering on a ResNet-18 trained on the card
    acc = accuracy_path(device, card)
    top1 = {name: c['top1'] for name, c in acc['configs'].items()}
    held = ordering_holds(top1)
    check(all(held.values()), f'accuracy ordering on the card-trained ResNet-18: {held}, '
          f'top-1 {top1}')
    check(all(abs(acc['cpu'][name]['top1'] - top1[name]) <= CARD_VS_CPU_TOP1
              for name in ('fp32', 'w8a8_serving')),
          f"accuracy_path top-1 card {top1} against the CPU {acc['cpu']}")
    # a 4-bit recipe's CPU run is one more draw of its float order
    check(all(band_holds(acc['band']['configs'][name]['top1'], acc['cpu'][name]['top1'],
                         acc['images'])[0] for name in BAND_CONFIGS),
          f"accuracy_path 4-bit top-1 on the CPU {acc['cpu']} outside the card's band "
          f"{acc['band']['configs']}")

    # ---- main path 2: true-int8 serving through the int8 GEMM and conv kernels
    eng, sp, scales, pq, images, srep = drive_serving_path(device)
    emit('serving_path', card=card, **srep)
    check_serving_path(srep)
    int8_resident_flow(eng, sp, scales, pq, images)
    kernels_vs_plain_end_to_end('serving_kernels_vs_plain_end_to_end', eng, sp, scales, images)
    emit('serving_step_profile', card=card, **profile_serving_forward(
        eng.make_forward(quantized='serving_int8', act_scales=scales), sp, images))
    del eng, sp, scales, pq

    # ---- main path 3: W4A4 packed serving through the int4-packed GEMM
    packed_card_vs_cpu(device)
    eng, sp, scales, images, prep = drive_packed_path(device)
    emit('packed_path', card=card, **prep)
    check_packed_path(prep)
    packed_flow(eng, sp, scales, images)
    packed_vs_plain_on_card(eng, sp, scales, images)
    kernels_vs_plain_end_to_end('packed_kernels_vs_plain_end_to_end', eng, sp, scales, images,
                                packed=True)
    packed_step_profile(eng, sp, scales, images, card)
    del eng, sp, scales

    # ---- main path 4: the throughput bench (bf16, batch 128, MobileNet-v2, the probes)
    del images
    bench_err = bench_calls_vs_plain(device)
    bench_launches = bench_path(device, card)
    bench_images = bench._images(BENCH_BATCH, 224, device)
    bf16_kernels_vs_plain_end_to_end(device, bench_images)
    mobilenet_kernels_vs_plain_end_to_end(device, bench_images)
    del bench_images

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
    codes_epilogue_timing(device, card)
    codes_timing = quantize_codes_timing(device, card)
    timing['int4_gemm'] = int4_timing(device, card)
    copy = stream_copy_timing(device, card)

    # launches of the slice-9, slice-10 and slice-11 phases, each run counted
    # from 0: the .npz CLI run, the tools (k-means read-back, golden runbook,
    # STE, cost_analysis), the parallel layer (one rank in process with the
    # checkpoint's two forwards; each of the two-rank runs' ranks), the
    # resume runs (both recipes, all three runs) and the ordering's six CLI
    # runs on the card
    par_routes, tool_routes = Counter(par['launches']), Counter(tools['launches'])
    gemm_routes, conv_routes = ('wgmma', 'mma_sync'), ('depthwise', 'im2col_wgmma',
                                                       'implicit_gemm')
    slice9 = {
        'fake_quant': dict(data_launches=data['launches'],
                           tools_launches=tool_routes['fake_quant'],
                           parallel_launches=par_routes['fake_quant'],
                           resume_launches=resume['launches'].get('fake_quant', 0),
                           accuracy_launches=acc['launches'].get('fake_quant', 0)),
        'int8_gemm': dict(data_launches=0, tools_launches=sum(tool_routes[r] for r in gemm_routes),
                          parallel_launches=sum(par_routes[r] for r in gemm_routes),
                          resume_launches=resume['launches'].get('int8_gemm', 0),
                          accuracy_launches=acc['launches'].get('int8_gemm', 0)),
        'int8_conv': dict(data_launches=0, tools_launches=sum(tool_routes[r] for r in conv_routes),
                          parallel_launches=sum(par_routes[r] for r in conv_routes),
                          resume_launches=resume['launches'].get('int8_conv', 0),
                          accuracy_launches=acc['launches'].get('int8_conv', 0)),
        'int4_gemm': dict(data_launches=0, tools_launches=0, parallel_launches=0,
                          resume_launches=0, accuracy_launches=0),
        'stream_copy': dict(data_launches=0, tools_launches=0, parallel_launches=0,
                            resume_launches=0, accuracy_launches=0),
    }

    def int8_row(name, source, replaces, launches, err):
        # the kernels line carries the heaviest shape; the others are in the
        # timing phases.  kernel_route: the hand-written route that shape takes
        t = timing[name][0]
        return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
                'shape': t['shape'], 'kernel_route': t['route'], 'launches': launches,
                'bench_launches': bench_launches[name],
                **({'zoo_launches': zoo[name]} if name in zoo else {}), **slice9[name],
                'max_abs_err': max(err, bench_err[name]), 'ms': t['ms'],
                'old_route_ms': t.get('old_route_ms'),
                'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
                'bound_by': t['bound_by'], 'library_ms': t['library_ms']}

    print(json.dumps({'card': card, 'kernels': [
        {'name': 'fake_quant', 'route': 'cuda',
         'source': 'cnn_quantization_tpu_torch/csrc/fake_quant.cu',
         'replaces': REPLACES, 'modes': ['affine', 'stochastic', 'reference_per_tensor'],
         'launches': rep['launches'], 'cli_launches': cli['launches'],
         'bench_launches': bench_launches['fake_quant'], 'zoo_launches': zoo['fake_quant'],
         **slice9['fake_quant'], 'max_abs_err': max(max_err, bench_err['fake_quant']), 'ms': ms,
         'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
         'library_ms': library_ms},
        int8_row('int8_gemm', 'cnn_quantization_tpu_torch/csrc/int8_gemm.cu', REPLACES_GEMM,
                 srep['gemm_launches'], gemm_err),
        int8_row('int8_conv', 'cnn_quantization_tpu_torch/csrc/int8_conv.cu', REPLACES_CONV,
                 srep['conv_launches'], conv_err),
        dict(int8_row('int4_gemm', 'cnn_quantization_tpu_torch/csrc/int4_gemm.cu', REPLACES_INT4,
                      prep['launches']['int4_gemm'], int4_err),
             modes=sorted({c[6] for c in INT4_CASES.values()})),
        {'name': 'stream_copy', 'route': 'cuda',
         'source': 'cnn_quantization_tpu_torch/csrc/stream_copy.cu', 'replaces': REPLACES_COPY,
         'shape': copy['shape'], 'launches': bench_launches['stream_copy'],
         **slice9['stream_copy'], 'max_abs_err': max(copy_worst, bench_err['stream_copy']),
         'ms': copy['ms'], 'plain_ms': copy['plain_ms'],
         'bound_ms': copy['bound_ms'], 'bound_by': copy['bound_by'],
         'library_ms': copy['library_ms']},
        codes_row(srep, codes_timing)]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        if sys.argv[1:2] == ['--parallel-worker']:
            sys.exit(parallel_worker(sys.argv[2:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f'chip_smoke FAILED: {e}', file=sys.stderr)
        sys.exit(1)
