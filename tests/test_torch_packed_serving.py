"""The port's W4A4 packed serving path against the JAX package: ResNet-50 at
64x64, batch 2 (the smallest trunk that can pack: every block's output
channels are a multiple of 256), on the CPU (plain versions of the kernels;
the JAX side runs its Pallas kernel in interpret mode), from the same
BN-folded weights and numpy-seeded inputs.

JAX's weight pass, prepared serving tree and frozen scales are carried across
by the weight bridge wherever a forward is compared, so both sides compute on
identical codes and scales.  Tolerances and their reasons:

  * ``freeze_serving_scales(packed=True)`` against un-jitted JAX: the same
    keys, values within 1e-5 relative (the sums for E|x| run in another
    order), ``:out:packed == :out * 127/7`` to 1e-6;
  * teacher-forced blocks (the port's own block input, codes or packed bytes,
    through a JAX ``Bottleneck`` and the port's): packed bytes and int8 codes
    equal, or off by one step at fewer than 1e-3 of the elements (the JAX
    kernel runs under its own ``jit``, where XLA may contract the epilogue's
    multiply and add into one rounding, which moves a value that sits on a
    rounding tie); the last block's float output within 1e-5 relative;
  * the port's packed forward ``torch.equal`` to the port's plain forward
    given the packed-grid ``:out`` scales: the same separately rounded
    operations, rearranged into the GEMM's epilogue;
  * whole-model logits against the eager JAX packed forward: finite, and the
    relative error is reported, which is the bar ``tests/test_torch_serving.py``
    holds the W4A4 grid to: on a +-7 grid over 53 sites one flipped code (the
    float stem sums in another order) moves every code behind it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu.engine.context import ServingInt8Context as JServingInt8Context
from cnn_quantization_tpu.models.layers import PackedQTensor as JPackedQTensor
from cnn_quantization_tpu.models.layers import QTensor as JQTensor
from cnn_quantization_tpu.models.resnet import Bottleneck as JBottleneck
from cnn_quantization_tpu.ops.kernels.int4_matmul import unpack_int4 as j_unpack

from cnn_quantization_tpu_torch.engine.engine import ModelMeta
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models import resnet as port_resnet
from cnn_quantization_tpu_torch.models.layers import (PackedQTensor, QConv, QTensor,
                                                      init_parameters)
from cnn_quantization_tpu_torch.ops.kernels import int4_matmul as i4
from cnn_quantization_tpu_torch.utils.flax_params import (act_scales_from_jax,
                                                          state_dict_from_flax)

from _torch_parity import JEngine, JPolicy, Pair, QuantEngine, QuantPolicy

ARCH, SIZE = 'resnet50', 64
W4A4 = dict(qtype='int4', qweight='int4')


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _batch(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(2, SIZE, SIZE, 3).astype(np.float32)


class Served:
    """Both engines on the W4A4 grid; JAX's weight pass, prepared tree and
    packed-frozen scales carried across by the bridge."""

    def __init__(self):
        pair = Pair(ARCH, SIZE)
        self.pair = pair
        self.j_eng = JEngine(pair.j_model, JPolicy(arch=ARCH, **W4A4), pair.j_meta)
        self.eng = QuantEngine(pair.model, QuantPolicy(arch=ARCH, **W4A4), pair.meta)
        self.j_sp = self.j_eng.prepare_serving_params(self.j_eng.quantize_params(pair.j_params))
        self.sp = state_dict_from_flax(self.j_sp)
        self.cal = [(_batch(0), np.zeros(2, np.int32))]
        self.x = _batch(1)
        with jax.disable_jit():
            self.j_scales = self.j_eng.freeze_serving_scales(self.j_sp, self.cal, packed=True)
        self.scales = act_scales_from_jax(self.j_scales)
        # the plain path's comparison scales: ':out' identity codes on the
        # packed grid (step absmax / 7; the +-127 clip is then a no-op)
        self.cmp_scales = {k: self.scales.get(k + ':packed', v) for k, v in self.scales.items()}

    def forward(self, scales, packed=False):
        return self.eng.make_forward(quantized='serving_int8', act_scales=scales,
                                     packed=packed)(self.sp, None, self.x)[0]


@pytest.fixture(scope='module')
def served():
    return Served()


@pytest.fixture()
def int4_calls(monkeypatch):
    """Counts calls of the int4 GEMM wrapper (the plain version runs here)."""
    calls = []
    real = i4.int4_matmul

    def counting(*args, **kw):
        calls.append(kw.get('out_mode', 'f32'))
        return real(*args, **kw)

    monkeypatch.setattr(i4, 'int4_matmul', counting)
    return calls


# ------------------------------------------------------------------- scales

def test_freeze_packed_scales_match_jax(served):
    got = served.eng.freeze_serving_scales(served.sp, served.cal, packed=True)
    want = served.j_scales
    assert set(got) == set(want)
    assert len([k for k in got if k.startswith('conv')]) >= 53
    outs = [k for k in got if k.endswith(':out')]
    assert len(outs) == 4   # one downsample conv a stage
    for k in outs:
        assert k + ':packed' in got
        # the int4 grid's step is 127/7 coarser for the same calibrated clip
        np.testing.assert_allclose(got[k + ':packed'], got[k] * 127.0 / 7.0, rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    plain = served.eng.freeze_serving_scales(served.sp, served.cal, packed=False)
    assert set(plain) == {k for k in got if not k.endswith(':packed')}
    assert all(plain[k] == got[k] for k in plain)


def test_bridge_carries_packed_scales(served):
    assert set(served.scales) == set(served.j_scales)
    for k, v in served.scales.items():
        assert isinstance(v, float) and v == float(served.j_scales[k]), k


# --------------------------------------------------- teacher-forced blocks

@pytest.fixture(scope='module')
def block_io(served):
    """Every block's (input, out_spec, output) in one packed forward of the
    port."""
    seen = {}
    real = port_resnet.Bottleneck.forward
    names = {m: n for n, m in served.pair.model.named_modules()}

    def recording(self, x, ctx, out_spec=False):
        y = real(self, x, ctx, out_spec=out_spec)
        seen[names[self]] = (x, out_spec, y)
        return y

    port_resnet.Bottleneck.forward = recording
    try:
        served.forward(served.scales, packed=True)
    finally:
        port_resnet.Bottleneck.forward = real
    return seen


def _to_jax(x):
    """A port block input (NCHW) as the JAX package's (NHWC)."""
    nhwc = lambda t: jnp.asarray(np.ascontiguousarray(t.permute(0, 2, 3, 1).numpy()))  # noqa: E731
    if isinstance(x, PackedQTensor):
        return JPackedQTensor(nhwc(x.codes), jnp.float32(float(x.scale)))
    if isinstance(x, QTensor):
        return JQTensor(nhwc(x.codes), jnp.float32(float(x.scale)))
    return nhwc(x)


@pytest.mark.parametrize('name,in_kind,out_kind', [
    ('layer1.0', QTensor, PackedQTensor),         # int8 in from the max-pool, a downsample
    ('layer1.1', PackedQTensor, PackedQTensor),   # no downsample: the input is the identity
    ('layer2.0', PackedQTensor, PackedQTensor),   # strided, rows sliced ahead of the GEMM
    ('layer4.2', PackedQTensor, torch.Tensor),    # the last block: float out
])
def test_teacher_forced_block_matches_jax(served, block_io, name, in_kind, out_kind):
    x, out_spec, y = block_io[name]
    assert isinstance(x, in_kind) and isinstance(y, out_kind)
    li, bi = int(name[5]) - 1, int(name[7])
    spec = served.pair.j_model.stage_specs[li][bi]
    ctx = JServingInt8Context(act_scales=served.j_scales, act_bits=4, weight_bits=4, packed=True)
    j_spec = None if out_spec is None else (out_spec[0], jnp.float32(float(out_spec[1])))
    want = JBottleneck(spec).apply({'params': served.j_sp[f'layer{li + 1}_{bi}']}, _to_jax(x),
                                   ctx, out_spec=j_spec)
    if out_kind is torch.Tensor:
        got = y.permute(0, 2, 3, 1).numpy()
        assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
        assert _rel(got, want) <= 1e-5
        return
    assert float(y.scale) == float(want.scale)
    got = y.codes.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.codes)
    assert got.dtype == np.int8 and got.shape == want.shape
    if not np.array_equal(got, want):   # bytes differ: at most one step, rarely
        g = i4.unpack_int4(torch.from_numpy(got)).numpy().astype(np.int32)
        w = np.asarray(j_unpack(jnp.asarray(want))).astype(np.int32)
        diff = np.abs(g - w)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


# ------------------------------------------------------------ whole forwards

def test_packed_forward_equals_plain_under_packed_grid_scales(served, int4_calls):
    plain = served.forward(served.cmp_scales)
    assert int4_calls == []
    packed = served.forward(served.scales, packed=True)
    # 16 x conv1 and 16 x conv2->conv3 hand-overs as int8 codes, 4 downsamples
    # and 15 block boundaries packed, the last block float
    assert len(int4_calls) == 36
    assert int4_calls.count('int8') == 16 and int4_calls.count('packed') == 19
    assert int4_calls.count('f32') == 1
    assert bool(torch.isfinite(packed).all()) and tuple(packed.shape) == (2, 1000)
    assert torch.equal(packed, plain)


def test_packed_logits_against_eager_jax(served, record_property):
    want, _ = served.j_eng.make_forward(quantized='serving_int8', act_scales=served.j_scales,
                                        packed=True)(served.j_sp, None, jnp.asarray(served.x))
    got = served.forward(served.scales, packed=True).numpy()
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all() and got.shape == want.shape
    record_property('w4a4_packed_logits_rel', _rel(got, want))
    record_property('w4a4_packed_argmax_equal', bool((got.argmax(-1) == want.argmax(-1)).all()))


def test_blocks_are_fed_packed_codes(served, block_io):
    """In the fully packed forward every block but the first takes a
    ``PackedQTensor`` and every block but the last emits one."""
    names = list(block_io)
    assert len(names) == 16
    for i, name in enumerate(names):
        x, out_spec, y = block_io[name]
        assert isinstance(x, QTensor if i == 0 else PackedQTensor), name
        assert isinstance(y, torch.Tensor if i == 15 else PackedQTensor), name
        assert (out_spec is None) == (i == 15)
    x, _, y = block_io['layer2.0']
    assert x.codes.shape[1] * 2 == 256 and y.codes.shape[1] * 2 == 512
    assert y.codes.permute(0, 2, 3, 1).is_contiguous()   # channels_last memory


# ------------------------------------------------------------------- guards

def test_packed_falls_back_without_packed_scales(served, int4_calls):
    """No ``:out:packed`` keys: the plain path, everywhere."""
    partial = {k: v for k, v in served.scales.items() if not k.endswith(':out:packed')}
    got = served.forward(partial, packed=True)
    assert int4_calls == []
    assert torch.equal(got, served.forward(partial))


def test_plain_frozen_scales_never_engage_packed(served, int4_calls):
    cal = [(_batch(3), np.zeros(2, np.int32))]
    plain_scales = served.eng.freeze_serving_scales(served.sp, cal, packed=False)
    assert not any(k.endswith(':out:packed') for k in plain_scales)
    got = served.forward(plain_scales, packed=True)
    assert int4_calls == []
    assert torch.equal(got, served.forward(plain_scales))


def test_stale_scales_fall_back_in_full(served, int4_calls):
    """Scales that lack one trunk key (a conv2 input scale deep in stage 3)
    fall back in full, never in part: no int4 GEMM runs at all."""
    conv2 = served.pair.model.layer3[4].conv2.site.id
    stale = {k: v for k, v in served.scales.items() if k != conv2}
    got = served.forward(stale, packed=True)
    assert int4_calls == []
    assert torch.equal(got, served.forward(stale))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize('arch,fold', [('resnet18', True), ('resnext50_32x4d', False)])
def test_other_trunks_ignore_packed(int4_calls, arch, fold):
    """BasicBlock trunks cannot pack (3x3 convs); resnext50 is a Bottleneck
    trunk but is not BN-folded.  ``packed=True`` is a no-op for both."""
    if arch == 'resnet18':
        model, meta = build_model(arch, device='cpu', seed=1)
    else:
        model = init_parameters(port_resnet.build_resnet(arch, fold_bn=fold), 1).eval()
        meta = ModelMeta(arch=arch, fold_bn=fold)
    eng = QuantEngine(model, QuantPolicy(arch=arch, **W4A4), meta)
    sp = eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))
    scales = eng.freeze_serving_scales(sp, [(_batch(1), np.zeros(2, np.int32))], packed=True)
    x = _batch(2)
    plain, _ = eng.make_forward(quantized='serving_int8', act_scales=scales)(sp, None, x)
    packed, _ = eng.make_forward(quantized='serving_int8', act_scales=scales,
                                 packed=True)(sp, None, x)
    assert int4_calls == []
    assert torch.equal(plain, packed) and bool(torch.isfinite(packed).all())


@pytest.mark.parametrize('stages,calls', [((1,), 7), ((2, 3), 22), ((4,), 7), ((1, 3), 20)])
def test_packed_stage_selection(served, int4_calls, stages, calls):
    """``packed`` as a tuple of 1-based stages: those run the packed
    orchestration (2 GEMMs a block and 1 a downsample), the rest the plain
    path, with int8 codes at a packed -> plain boundary."""
    got = served.forward(served.scales, packed=stages)
    assert len(int4_calls) == calls
    assert bool(torch.isfinite(got).all())
    # a packed stage followed by a plain one ends in int8 codes, not bytes
    boundaries = sum(1 for s in stages if s < 4 and s + 1 not in stages)
    assert int4_calls.count('int8') == (calls - len(stages)) // 2 + boundaries


def test_all_stages_equal_packed_true(served):
    assert torch.equal(served.forward(served.scales, packed=(1, 2, 3, 4)),
                       served.forward(served.scales, packed=True))
    assert torch.equal(served.forward(served.scales, packed=[1, 2, 3, 4]),
                       served.forward(served.scales, packed=True))


def test_packed_needs_four_bit_activations(served):
    """The packed epilogue clamps to +-7 whatever the grid: asking for it on
    an 8-bit policy raises instead of crushing +-127 codes."""
    eng8 = QuantEngine(served.pair.model, QuantPolicy(arch=ARCH, qtype='int8', qweight='int8'),
                       served.pair.meta)
    with pytest.raises(ValueError, match='4-bit codes'):
        eng8.make_forward(quantized='serving_int8', act_scales=served.scales, packed=True)
    eng8.make_forward(quantized='serving_int8', act_scales=served.scales)   # plain is fine


def test_packed_qtensor_dequant(served, block_io):
    x, _, _ = block_io['layer1.1']
    deq = x.dequant()
    assert tuple(deq.shape) == (2, 256, 16, 16) and deq.dtype == torch.float32
    codes = i4.unpack_int4(x.codes.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert int(codes.abs().max()) <= 7
    assert torch.equal(deq, codes.float() * x.scale)


def test_conv_orchestration_inputs_fail_loudly_off_the_packed_path(served):
    """A residual, an ``out_spec`` or a fused ReLU that the conv could not
    honour raises instead of being dropped."""
    from cnn_quantization_tpu_torch.engine.context import ServingInt8Context, TapContext
    conv = served.pair.model.layer1[0].conv3
    x = torch.zeros(1, 64, 8, 8)
    res = PackedQTensor(torch.zeros(1, 128, 8, 8, dtype=torch.int8), torch.tensor(1.0))
    for kw in (dict(residual=res), dict(out_spec=('int8', 1.0)), dict(fuse_relu=True)):
        with pytest.raises(ValueError, match='true-int serving path'):
            conv(x, TapContext(), **kw)
    # serving, but float params and no packed flag: past the packed branch
    with pytest.raises(ValueError, match='packed 1x1 GEMM path'):
        conv(x, ServingInt8Context(), residual=res)
    with pytest.raises(ValueError, match='fuse_relu without out_spec'):
        conv(x, ServingInt8Context(), fuse_relu=True)
    assert isinstance(conv, QConv)
