"""The int8 kernels' two epilogue features that let a ResNet serving block hand
int8 codes from kernel to kernel: codes out (the value's codes at the next
layer's frozen scale) and residual in (the block's identity codes, added at
their scale before the ReLU).

On the CPU the wrappers run the plain versions (``int_matmul.fused_epilogue``).
They are held bit for bit to the elementwise ops the serving path ran after a
float-out kernel before the features existed, spelled out here from
``dequant_epilogue``'s float output, ``QTensor.dequant`` and
``quantize_sym_codes_plain``; whole serving forwards are held bit for bit to that
path's block orchestration, spelled out here as well; the counters show where
the features engage.  The ``cuda`` test holds each tensor-core route's
epilogue to the plain version on the card.  This file imports no JAX, so the
card runs it: ``python -m pytest --noconftest -m cuda
tests/test_torch_codes_epilogue.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
from cnn_quantization_tpu_torch.models import build_model, inception, resnet
from cnn_quantization_tpu_torch.models.googlenet import BasicConv2d
from cnn_quantization_tpu_torch.models.layers import QConv, QLinear, QTensor, relu
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.ops.kernels.int_matmul import quantize_sym_codes_plain
from cnn_quantization_tpu_torch.utils import counters, profiling, spans

SIZE = 64
# (codes out, residual in, codes at one scale a column)
FEATURES = {'codes': (True, False, False), 'codes_per_group': (True, False, True),
            'residual': (False, True, False), 'both': (True, True, False),
            'both_per_group': (True, True, True)}
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """PyTorch's plain int32 grouped and depthwise convs on the CPU stall
    under several test workers (OpenMP barriers on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(shape, gen, device='cpu'):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(device)


def _elementwise(y, fuse_relu, out_scale, bits, residual, shape):
    """The serving path's ops after a float-out kernel: the identity
    dequantized in ``y``'s type and added, the ReLU, then the next conv's
    input quantization (per tensor, or per group viewed as ``shape``)."""
    if residual is not None:
        y = y + QTensor(*residual).dequant(y.dtype)
        if fuse_relu:
            y = relu(y)
    if out_scale is not None:
        y = quantize_sym_codes_plain(y, out_scale.view(shape) if out_scale.ndim else out_scale,
                                     bits)
    return y


def _case(kind, gen, device='cpu'):
    """(plain version, its arguments, the output's shape, per-column view, its
    column groups): a GEMM with ragged M and N, an ungrouped 3x3 conv, a
    grouped conv with per-group alpha."""
    if kind == 'gemm':
        a, bt = _codes((37, 48), gen, device), _codes((24, 48), gen, device)
        alpha = (torch.rand(24, generator=gen) * 2e-4).to(device)
        args = (a, bt.t(), alpha, torch.randn(24, generator=gen).to(device))
        return im.int8_matmul_dequant_plain, args, {}, (37, 24), (1, -1), 1
    groups = 4 if kind == 'grouped' else 1
    x = _codes((2, 16, 7, 5), gen, device).contiguous(memory_format=torch.channels_last)
    w = _codes((24, 16 // groups, 3, 3), gen, device).contiguous(memory_format=torch.channels_last)
    alpha = (torch.rand(groups, generator=gen) * 2e-4).repeat_interleave(24 // groups).to(device)
    kw = dict(strides=(2, 1), padding=(1, 1), groups=groups)
    args = (x, w, alpha * torch.rand(24, generator=gen).to(device),
            torch.randn(24, generator=gen).to(device))
    return ic.int8_conv_dequant_plain, args, kw, (2, 24, 4, 5), (1, -1, 1, 1), groups


def _scales(per_group, groups, n, gen, device='cpu'):
    """The codes' scale: one value, or one a column, constant in each of
    ``groups`` column groups (a grouped consumer's per-group input scale)."""
    if not per_group:
        return torch.full((), 0.05, device=device)
    return (torch.rand(groups, generator=gen) * 0.05 + 0.02).repeat_interleave(n // groups).to(
        device)


@pytest.mark.parametrize('kind', ['gemm', 'conv', 'grouped'])
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('feature', list(FEATURES))
def test_plain_epilogue_equals_the_elementwise_ops(kind, dtype, feature):
    gen = torch.Generator().manual_seed(list(FEATURES).index(feature))
    codes, res, per_group = FEATURES[feature]
    plain, args, kw, shape, view, groups = _case(kind, gen)
    if per_group and kind != 'grouped':
        groups = 4   # the per-group input scale of a grouped consumer
    out_scale = _scales(per_group, groups, shape[1], gen) if codes else None
    residual = (_codes(shape, gen), torch.full((), 0.03)) if res else None
    for fuse_relu in (False, True):
        y = plain(*args, fuse_relu=fuse_relu and residual is None, out_dtype=dtype, **kw)
        want = _elementwise(y, fuse_relu, out_scale, 4 if fuse_relu else 8, residual, view)
        got = plain(*args, fuse_relu=fuse_relu, out_dtype=dtype, out_scale=out_scale,
                    out_bits=4 if fuse_relu else 8, residual=residual, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want), (fuse_relu, feature)
        if out_scale is not None:
            assert 0 < int((got != 0).sum()) and int(got.abs().max()) <= (7 if fuse_relu else 127)


def _elementwise_forward(self, x, ctx):
    """``ResNet.forward`` as the serving path ran it before the codes came out
    of the kernels: every conv writes floats; the stem output and each block
    input are quantized once at conv1's scale, conv2 and conv3 quantize their
    ReLU'd float inputs, the downsample's output is quantized at its ':out'
    scale, and the identity is dequantized for the add."""
    scales, bits = ctx.act_scales, ctx.act_bits
    blocks = [blk for li in range(self.stages) for blk in getattr(self, f'layer{li + 1}')]
    y = relu(self.conv1(x.to(self.dtype), ctx))
    s = scales[blocks[0].spec.conv_sites[0][0].id]
    y = self.maxpool(QTensor(quantize_sym_codes_plain(y, s, bits), s), ctx)
    for blk in blocks:
        sp = blk.spec
        s = scales[sp.conv_sites[0][0].id]
        q = y if isinstance(y, QTensor) else QTensor(quantize_sym_codes_plain(y, s, bits), s)
        convs = [blk.conv1, blk.conv2] + ([blk.conv3] if sp.bottleneck else [])
        out = convs[0](q, ctx)
        for conv in convs[1:]:
            out = conv(relu(out), ctx)
        identity = q.dequant(sp.dtype)
        if sp.has_downsample:
            s_out = scales[sp.ds_sites[0].id + ':out']
            d = blk.downsample[0](q, ctx)
            identity = QTensor(quantize_sym_codes_plain(d, s_out), s_out).dequant(sp.dtype)
        y = relu(out + identity)
    y = self.avgpool(y, ctx)
    return self.fc(y.flatten(1), ctx).float()


def _serving(arch, dtype='float32', grid='int8', size=SIZE):
    model, meta = build_model(arch, device='cpu', seed=3, dtype=dtype, input_size=size)
    eng = QuantEngine(model, QuantPolicy(arch=arch, qtype=grid, qweight=grid), meta)
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))
    rng = np.random.RandomState(4)
    cal = [(rng.rand(2, size, size, 3).astype(np.float32), np.zeros(2, np.int32))]
    return eng, sp, cal, rng.rand(2, size, size, 3).astype(np.float32)


@pytest.mark.parametrize('arch,dtype,grid', [('resnet18', 'float32', 'int8'),
                                             ('resnet18', 'float32', 'int4'),
                                             ('resnet50', 'float32', 'int8'),
                                             ('resnet50', 'bfloat16', 'int8')])
def test_serving_forward_equals_the_elementwise_path(arch, dtype, grid, monkeypatch):
    """Frozen scales: the codes handed from kernel to kernel give the logits
    of the elementwise path bit for bit, and every conv but the last block's
    last hands codes on."""
    eng, sp, cal, x = _serving(arch, dtype, grid)
    fwd = eng.make_forward(quantized='serving_int8',
                           act_scales=eng.freeze_serving_scales(sp, cal))
    emitted = {}
    real_conv = QConv.forward

    def conv(self, x, ctx, **kw):
        y = real_conv(self, x, ctx, **kw)
        emitted[self.site.id] = isinstance(y, QTensor)
        return y

    with monkeypatch.context() as m:
        m.setattr(QConv, 'forward', conv)
        got, _ = fwd(sp, None, x)
    floats = sorted(k for k, v in emitted.items() if not v)
    last = getattr(eng.model, 'layer4')[-1]
    assert floats == sorted([eng.model.conv1.site.id,
                             (last.conv3 if last.spec.bottleneck else last.conv2).site.id])
    monkeypatch.setattr(resnet.ResNet, 'forward', _elementwise_forward)
    want, _ = fwd(sp, None, x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _forward_counts(fwd, *args):
    """The counts of the ``engine.forward`` span of ``fwd(*args)`` (on the
    CPU no kernel launches: the epilogue features and the bytes alone)."""
    mark = spans.snapshot()['spans']
    mark = mark[-1].seq if mark else -1
    fwd(*args)
    (f,) = [s for s in spans.snapshot()['spans'] if s.seq > mark and s.name == 'engine.forward']
    return f.counts


@contextlib.contextmanager
def _bytes_seen(model):
    """Counts, at the modules' boundaries, what a forward should count: the
    float32 bytes of every floating input an integer conv (in_ch != 3) or
    the classifier takes (codes count nothing), and the bytes of every
    concatenation: each Inception-v3 mixed block's output, and inside a
    Mixed_7b/7c the outputs of the two pairs of 1x3/3x1 convs it joins."""
    seen = {'int8_conv.float_in_bytes': 0, 'int8_gemm.float_in_bytes': 0, 'concat.bytes': 0}

    def float_in(key):
        def hook(mod, args):
            if not isinstance(args[0], QTensor):
                seen[key] += args[0].numel() * 4
        return hook

    def out_bytes(mod, args, y):
        seen['concat.bytes'] += y.numel() * 4

    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, QConv) and mod.in_ch != 3:
            handles.append(mod.register_forward_pre_hook(float_in('int8_conv.float_in_bytes')))
        elif isinstance(mod, QLinear):
            handles.append(mod.register_forward_pre_hook(float_in('int8_gemm.float_in_bytes')))
        elif isinstance(mod, inception._Mixed) or (
                isinstance(mod, BasicConv2d) and name.split('.')[-1] in (
                    'branch3x3_2a', 'branch3x3_2b', 'branch3x3dbl_3a', 'branch3x3dbl_3b')):
            handles.append(mod.register_forward_hook(out_bytes))
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()
        for k in [k for k, n in seen.items() if n == 0]:
            del seen[k]


@pytest.mark.parametrize('arch,want', [
    # 16 conv1 + 15 conv3 + layer1's stride-1 downsample on the GEMM, 16
    # conv2 + 3 strided downsamples on the conv; the identity into each conv3
    ('resnet50', {'int8_gemm.codes_out': 32, 'int8_conv.codes_out': 19,
                  'int8_gemm.residual_in': 16}),
    ('mobilenet_v2', {}),
    # floats between every conv; 15 concatenations
    ('inception_v3', {})])
def test_feature_counts_per_forward(arch, want):
    """Per serving forward with frozen scales, in the ``engine.forward``
    span: codes out and residuals in, nothing of them without frozen scales
    nor in calibration; the bytes of floats the integer convs and the
    classifier quantize on entry, and of the concatenations, with and
    without frozen scales."""
    eng, sp, cal, x = _serving(arch, size=75 if arch == 'inception_v3' else SIZE)
    before = counters.snapshot()
    scales = eng.freeze_serving_scales(sp, cal)
    assert not [k for k in counters.since(before) if k.endswith(('.codes_out', '.residual_in'))]
    for fwd, features in ((eng.make_forward(quantized='serving_int8', act_scales=scales), want),
                          (eng.make_forward(quantized='serving_int8'), {})):
        with _bytes_seen(eng.model) as seen:
            got = _forward_counts(fwd, sp, None, x)
        assert got == dict(features, **seen)
        fc = next(m for m in eng.model.modules() if isinstance(m, QLinear))
        assert seen['int8_gemm.float_in_bytes'] == 2 * fc.weight.shape[1] * 4
        assert ('concat.bytes' in seen) == (arch == 'inception_v3')
    if arch == 'inception_v3':
        # at 75x75 the blocks write 256, 288 and 288 channels at 7x7, 768 at
        # 3x3 five times, 1280, 2048 and 2048 at 1x1, and 7b and 7c join two
        # pairs of 384 channels at 1x1 each
        assert seen['concat.bytes'] == 2 * 4 * (
            (256 + 288 + 288) * 49 + 768 * 9 * 5 + 1280 + 2 * (2048 + 2 * 768))


def test_feature_counts_equal_under_count_work():
    """A serving forward run inside ``profiling.count_work``, whose stand-ins
    replace the kernel wrappers while it counts, moves the store's epilogue
    and float-in counters exactly as the same forward run bare."""
    eng, sp, cal, x = _serving('resnet18')
    fwd = eng.make_forward(quantized='serving_int8', act_scales=eng.freeze_serving_scales(sp, cal))
    keys = [f'int8_{k}.{f}' for k in ('gemm', 'conv')
            for f in ('float_in_bytes', 'codes_out', 'residual_in')]
    moved = []
    for run in (lambda: fwd(sp, None, x),
                lambda: profiling.count_work(eng.model, lambda: fwd(sp, None, x))):
        before = counters.snapshot()
        run()
        moved.append({k: n for k, n in counters.since(before).items() if k in keys})
    # the classifier's 512 float32 inputs a image; codes out of every conv
    # but the last block's conv2, the identity into each block's conv2
    assert moved[0] == moved[1] == {'int8_gemm.float_in_bytes': 2 * 512 * 4,
                                    'int8_conv.codes_out': 18, 'int8_conv.residual_in': 8}


def test_forward_without_frozen_scales_keeps_floats(monkeypatch):
    """Dynamic serving: every conv takes and writes floats, as before."""
    eng, sp, _, x = _serving('resnet50')
    kinds = set()
    real_conv = QConv.forward

    def conv(self, x, ctx, **kw):
        y = real_conv(self, x, ctx, **kw)
        kinds.add((type(x).__name__, type(y).__name__, tuple(sorted(kw))))
        return y

    monkeypatch.setattr(QConv, 'forward', conv)
    eng.make_forward(quantized='serving_int8')(sp, None, x)
    assert kinds == {('Tensor', 'Tensor', ())}


def _card_cases(route, gen):
    """(wrapper call, plain call, output shape, per-column view) at a route's
    shapes: ragged M and N, rows of fewer than 16 bytes (no TMA store), the
    64- and 128-column tiles."""
    dev = 'cuda'
    if route in ('wgmma', 'mma_sync'):
        shapes = (((3001, 256, 64), (777, 512, 200), (129, 64, 8)) if route == 'wgmma'
                  else ((300, 24, 50), (77, 40, 16)))
        for m, k, n in shapes:
            a, bt = _codes((m, k), gen, dev), _codes((n, k), gen, dev)
            alpha = (torch.rand(n, generator=gen) * 4e-5).to(dev)
            beta = torch.randn(n, generator=gen).to(dev)
            assert im.gemm_route(k) == route
            yield (lambda **f: im.int8_matmul_dequant(a, bt.t(), alpha, beta, **f),
                   lambda **f: im.int8_matmul_dequant_plain(a, bt.t(), alpha, beta, **f),
                   (m, n), (1, -1))
        return
    cl = torch.channels_last
    shapes = (((3, 64, 13, 11), 64, 3, 2, 1, 1), ((2, 128, 9, 7), 96, 3, 1, 1, 1),
              ((2, 64, 10, 10), 8, 3, 1, 1, 1), ((2, 256, 14, 14), 512, 1, 2, 0, 1))
    if route == 'implicit_gemm':
        shapes += (((2, 48, 9, 9), 64, 3, 1, 1, 1), ((2, 48, 9, 9), 64, 3, 2, 1, 4))
    for shape, o, k, s, p, groups in shapes:
        x = _codes(shape, gen, dev).contiguous(memory_format=cl)
        w = _codes((o, shape[1] // groups, k, k), gen, dev).contiguous(memory_format=cl)
        alpha = (torch.rand(o, generator=gen) * 3e-5).to(dev)
        bias = torch.randn(o, generator=gen).to(dev)
        ho, wo = (shape[2] + 2 * p - k) // s + 1, (shape[3] + 2 * p - k) // s + 1
        kw = dict(strides=(s, s), padding=(p, p), groups=groups)

        def kernel(x=x, w=w, alpha=alpha, bias=bias, s=s, p=p, groups=groups, **f):
            return ic.launch(x, w, alpha, bias, (s, s), (p, p), groups, f['fuse_relu'],
                             f['out_dtype'], route, f['out_scale'], f['out_bits'],
                             f['residual'])

        def plain(x=x, w=w, alpha=alpha, bias=bias, kw=kw, **f):
            return ic.int8_conv_dequant_plain(x, w, alpha, bias, **kw, **f)

        yield kernel, plain, (shape[0], o, ho, wo), (1, -1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['wgmma', 'mma_sync', 'im2col_wgmma', 'implicit_gemm'])
def test_route_epilogue_features_match_plain_on_card(route):
    """Codes out (one scale, and one a column) and residual in, alone and
    together, with and without the ReLU, float32 and bfloat16 values: each
    route's epilogue equals the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    gen = torch.Generator().manual_seed(5)
    for kernel, plain, shape, view in _card_cases(route, gen):
        res = (_codes(shape, gen, 'cuda'), torch.full((), 0.03, device='cuda'))
        if len(shape) == 4:
            res = (res[0].contiguous(memory_format=torch.channels_last), res[1])
        vec = (torch.rand(shape[1], generator=gen) * 0.05 + 0.02).cuda()
        for dt in DTYPES:
            for out_scale, residual, fuse_relu in (
                    (torch.full((), 0.05, device='cuda'), None, False), (vec, None, True),
                    (torch.full((), 0.05, device='cuda'), res, True), (None, res, True),
                    (vec, res, False)):
                f = dict(fuse_relu=fuse_relu, out_dtype=dt, out_scale=out_scale,
                         out_bits=8, residual=residual)
                got, want = kernel(**f), plain(**f)
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (route, shape, dt, out_scale is not None, residual is not None, fuse_relu)


QUOTIENT_CHECK = r'''
#include "int8_mma.cuh"

// every float v whose exponent lies within +-kQuotientExp, of both signs:
// the divisor's quotient against __fdiv_rn, bit for bit
__global__ void check(const float* scales, int ns, unsigned long long* bad) {
  const long long per = static_cast<long long>(2 * cnnq::kQuotientExp + 1) << 23;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int i = 0; i < ns; ++i) {
    const cnnq::Divisor d = cnnq::divisor(scales[i]);
    if (!d.ok) atomicAdd(bad, 1ULL << 40);
    for (long long k = blockIdx.x * blockDim.x + threadIdx.x; k < 2 * per; k += step) {
      const unsigned mag = (static_cast<unsigned>(127 - cnnq::kQuotientExp) << 23) +
                           static_cast<unsigned>(k % per);
      const float v = __uint_as_float(mag | (k >= per ? 0x80000000u : 0u));
      if (__float_as_uint(cnnq::quotient(v, d)) != __float_as_uint(__fdiv_rn(v, d.s))) {
        atomicAdd(bad, 1ULL);
      }
    }
  }
}

extern "C" int run(const float* scales, int ns, unsigned long long* bad) {
  check<<<1056, 256>>>(scales, ns, bad);
  return static_cast<int>(cudaDeviceSynchronize());
}
'''


@pytest.mark.cuda
def test_divisor_quotient_is_true_division_on_card(tmp_path):
    """The epilogue's quotient (the divisor's refined reciprocal, then one
    exact FMA correction) equals __fdiv_rn for every float whose exponent
    lies within the range it takes, for divisors across that range: powers
    of two, all-ones mantissas and random ones."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    import ctypes
    import subprocess
    from cnn_quantization_tpu_torch.ops.kernels import build
    src = tmp_path / 'quotient_check.cu'
    src.write_text(QUOTIENT_CHECK)
    lib = tmp_path / 'libquotient_check.so'
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, '-I', str(build.CSRC_DIR), '-o', str(lib),
                    str(src)], check=True, capture_output=True)
    rng = np.random.RandomState(8)
    exps = np.arange(-40, 41, 8)
    f32 = np.float32
    scales = np.concatenate([np.ldexp(f32(1), exps), np.nextafter(np.ldexp(f32(1), exps + 1), f32(0)),
                             np.ldexp(1 + rng.rand(40), rng.randint(-40, 40, 40)).astype(f32),
                             np.array([0.05, 0.0123, 1e-8, 3.7, 127.5], f32)]).astype(f32)
    s = torch.from_numpy(scales).cuda()
    bad = torch.zeros(1, dtype=torch.int64, device='cuda')
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert fn(s.data_ptr(), s.numel(), bad.data_ptr()) == 0
    assert int(bad) == 0
