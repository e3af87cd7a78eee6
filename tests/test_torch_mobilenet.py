"""The port's MobileNet-v2 against the JAX package's, on the CPU at 64x64.

One torchvision-style checkpoint (named as torchvision names MobileNet-v2:
``features.N.0``, ``features.N.conv.K``, ``classifier.1``) goes through the JAX
package's importer and back through the port's weight bridge, so the module
names of both packages are held to torchvision's.  Both BN settings are
covered: nothing folded (what the registry builds: 'mobilenet_v2' is not in
the reference's fold rule, and what the throughput bench serves) and
``fold_bn=True``, which folds the groups == 1 convs only and leaves the 17
depthwise BNs live.

Tolerances: site tables equal; float logits 1e-3 relative L2, equal argmax.
Serving is held against the JITTED JAX package on the model as the bench
serves it (nothing folded).  Eager JAX, which ``tests/test_torch_serving.py``
uses for ResNet-18 to get bit-tight bounds, compiles every op for every new
shape, and this trunk's 52 convs and 52 BNs cost over a minute of that; under
``jit`` XLA divides by a constant through its reciprocal, which moves a value
on a rounding tie by one code, so the bounds are in code steps: prepared codes
equal but for ties (under 0.1 % of them, by one step), ``w_scale`` 1e-6;
frozen and dynamic scales (17 of them ``[in_ch]`` vectors, one value per
depthwise channel) within 0.03 of the site's largest scale, the serving
path's own error budget (``tests/test_serving_int8.py``): every site sits
behind all earlier sites' codes, a flipped code moves a later abs-max by a
step of the 8-bit grid (1/127), and a channel all but dead after ReLU6 has an
abs-max set by rounding alone, so its own relative error says nothing (0.014
measured, two steps; 0.0088 with the groups == 1 BNs folded).  With JAX's
codes and
scales carried across, the frozen logits agree to 1e-2 relative with equal
argmax (the integer sums are exact); the dynamic logits to the same 0.03.

Beside those whole-model bounds, single inverted-residual blocks are held to
EAGER JAX (``jax.disable_jit``) on the port's own block input: the depthwise
scale vector channel by channel to 1e-6 relative, the block's output to
float32 rounding or one flipped code
(``test_teacher_forced_depthwise_block_matches_eager_jax``).

Every test here runs PyTorch on one thread: the plain int32 grouped
convolution of the CPU is slow, and under a parallel test run its OpenMP
barriers wait on descheduled threads for minutes.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu.engine.context import ServingInt8Context as JServingInt8Context
from cnn_quantization_tpu.engine.qparams import discover_sites as j_discover_sites
from cnn_quantization_tpu.models.mobilenetv2 import InvertedResidual as JInvertedResidual

from cnn_quantization_tpu_torch.engine.context import ServingInt8Context
from cnn_quantization_tpu_torch.engine.qparams import discover_sites
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.models.layers import QBatchNorm, QConv
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.utils.flax_params import (act_scales_from_jax,
                                                          state_dict_from_flax)

from _torch_parity import JEngine, JPolicy, Pair, QuantEngine, QuantPolicy, site_table

ARCH, SIZE = 'mobilenet_v2', 64
W8A8 = dict(qtype='int8', qweight='int8')


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module', params=[False, True], ids=['unfolded', 'folded'])
def pair(request):
    return Pair(ARCH, SIZE, fold_bn=request.param)


@pytest.fixture(scope='module')
def batches():
    rng = np.random.RandomState(0)
    return [(rng.rand(2, SIZE, SIZE, 3).astype(np.float32), np.zeros(2, np.int32))
            for _ in range(2)]


def test_registry_names_and_default_fold():
    for name in ('mobilenet_v2', 'mobilenetv2'):
        model, meta = build_model(name, device='cpu')
        assert meta.arch == 'mobilenet_v2' and meta.fold_bn is False
    assert sum(isinstance(m, QBatchNorm) for m in model.modules()) == 52


def test_site_table_equals_jax(pair):
    want = site_table(j_discover_sites(pair.j_model, (1, SIZE, SIZE, 3)), nhwc=True)
    got = site_table(discover_sites(pair.model, (1, 3, SIZE, SIZE)), nhwc=False)
    assert got == want
    convs = [r for r in got if r[0].startswith('conv')]
    bns = [r for r in got if r[0].startswith('bn')]
    assert len(convs) == 52 and got[-1][0] == 'linear0_activation'
    assert got[-1][1] == 'activation_classifier'
    # only groups == 1 convs fold their BN: the 17 depthwise BNs stay live
    assert len(bns) == (17 if pair.meta.fold_bn else 52)
    assert all(tag == 'activation' for _, tag, _, _, _ in bns)
    depthwise = [m for m in pair.model.modules() if isinstance(m, QConv) and m.groups > 1]
    assert len(depthwise) == 17 and all(m.groups == m.in_ch == m.features for m in depthwise)


def test_bridge_keeps_torchvision_names(pair):
    sd = state_dict_from_flax(pair.j_params)
    assert set(sd) == set(pair.model.state_dict())
    for key in ('features.0.0.weight', 'features.1.conv.0.0.weight', 'features.1.conv.1.weight',
                'features.3.conv.1.0.weight', 'features.3.conv.2.weight',
                'features.18.0.weight', 'classifier.1.weight', 'classifier.1.bias'):
        assert key in sd, key
    assert tuple(sd['features.3.conv.1.0.weight'].shape) == (144, 1, 3, 3)
    # a depthwise BN is live under either setting
    assert 'features.3.conv.1.1.running_var' in sd
    assert ('features.3.conv.3.running_var' in sd) == (not pair.meta.fold_bn)


def test_float_logits_match_jax(pair):
    got, want = pair.logits({})
    assert _rel(got, want) <= 1e-3
    assert (got.argmax(-1) == want.argmax(-1)).all()


class Serving:
    """Both engines on the registry's build, JAX's weight pass and prepared
    codes carried across by the weight bridge."""

    def __init__(self):
        pair = Pair(ARCH, SIZE)
        assert pair.meta.fold_bn is False
        self.pair = pair
        self.j_eng = JEngine(pair.j_model, JPolicy(arch=ARCH, **W8A8), pair.j_meta)
        self.eng = QuantEngine(pair.model, QuantPolicy(arch=ARCH, **W8A8), pair.meta)
        self.j_pq = self.j_eng.quantize_params(pair.j_params)
        self.pq = state_dict_from_flax(self.j_pq)
        self.j_sp = self.j_eng.prepare_serving_params(self.j_pq)
        self.sp = state_dict_from_flax(self.j_sp)


@pytest.fixture(scope='module')
def serving():
    return Serving()


def test_prepare_serving_params_codes_equal_but_for_ties(serving):
    got, want = serving.eng.prepare_serving_params(serving.pq), serving.sp
    assert set(got) == set(want)
    differing = total = 0
    for k, v in got.items():
        if k.endswith('.w_scale'):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
        elif v.dtype == torch.int8:
            assert want[k].dtype == torch.int8, k
            step = (v.int() - want[k].int()).abs()
            assert int(step.max()) <= 1, k
            differing, total = differing + int(step.sum()), total + v.numel()
        else:
            assert torch.equal(v, want[k]), k
    assert differing <= 1e-3 * total, (differing, total)
    assert got['features.0.0.weight'].dtype == torch.float32      # the float stem
    assert got['features.3.conv.1.0.weight'].dtype == torch.int8  # a depthwise conv
    assert sum(k.endswith('.w_scale') for k in got) == 52         # 51 convs + the classifier


def _scale_err(got, want):
    """The largest difference of a site's scales against the site's largest
    scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _vector_sites(scales):
    return sorted(k for k, v in scales.items() if np.ndim(v) == 1)


def test_frozen_serving_matches_jax(serving, batches, record_property):
    x = batches[0][0]
    j_scales = serving.j_eng.freeze_serving_scales(serving.j_sp, batches[:1])
    want, j_aux = jax.jit(serving.j_eng.make_forward(
        quantized='serving_int8', act_scales=j_scales))(serving.j_sp, None, jnp.asarray(x))
    scales = serving.eng.freeze_serving_scales(serving.sp, batches[:1])
    assert set(scales) == set(j_scales) and 'conv0_activation' not in scales
    vec = _vector_sites(scales)
    assert vec == _vector_sites(j_scales) and len(vec) == 17
    worst = max(_scale_err(scales[k], j_scales[k]) for k in j_scales)
    record_property('mobilenet_frozen_scales_worst', worst)
    assert worst <= 0.03, worst
    for k in vec:   # per depthwise channel: its own value for each of the in_ch
        assert scales[k].dtype == np.float32 and len(np.unique(scales[k])) > 1
    got, aux = serving.eng.make_forward(
        quantized='serving_int8', act_scales=act_scales_from_jax(j_scales))(serving.sp, None, x)
    assert aux == {} and j_aux == {}
    rel = _rel(got.numpy(), want)
    record_property('mobilenet_frozen_logits_rel', rel)
    assert bool(torch.isfinite(got).all()) and rel <= 1e-2, rel
    assert (got.numpy().argmax(-1) == np.asarray(want).argmax(-1)).all()


def test_dynamic_serving_matches_jax(serving, batches, record_property):
    x = batches[0][0]
    want, j_rec = jax.jit(serving.j_eng.make_forward(quantized='serving_int8'))(
        serving.j_sp, None, jnp.asarray(x))
    got, rec = serving.eng.make_forward(quantized='serving_int8')(serving.sp, None, x)
    assert set(rec) == set(j_rec) and len(rec) == 52   # 51 int8 convs + the classifier
    worst = max(_scale_err(rec[k].numpy(), j_rec[k]) for k in rec)
    record_property('mobilenet_dynamic_scales_worst', worst)
    assert worst <= 0.03, worst
    assert sum(v.ndim == 1 for v in rec.values()) == 17
    assert _rel(got.numpy(), want) <= 0.03


# --------------------------------------------------- teacher-forced blocks

@pytest.fixture(scope='module')
def block_inputs(serving, batches):
    """Every inverted-residual block's float input in one dynamic serving
    forward of the port."""
    seen = {}
    features = serving.pair.model.features
    hooks = [features[i].register_forward_pre_hook(
        lambda _m, args, i=i: seen.__setitem__(i, args[0].detach().clone()))
        for i in range(1, len(features) - 1)]
    try:
        serving.eng.make_forward(quantized='serving_int8')(serving.sp, None, batches[0][0])
    finally:
        for h in hooks:
            h.remove()
    return seen


# A teacher-forced block's output against eager JAX's: equal to float32
# rounding (3e-8 to 7e-8 measured) unless an ulp of a live BN put one
# activation on the other side of a rounding tie; one flipped 8-bit code moves
# the outputs behind it by a grid step (6e-5 measured in the stride-2 block).
BLOCK_TOL = 2e-4


def _block(serving, idx, x, act_scales=None):
    """Block ``features.idx`` of both packages on the port's own block input,
    JAX op by op (``jax.disable_jit``: true division, no contracted epilogue).
    Returns ((port output NHWC, recorded, depthwise codes), (JAX output,
    recorded))."""
    prefix = f'features.{idx}.'
    params = {k[len(prefix):]: v for k, v in serving.sp.items() if k.startswith(prefix)}
    ctx = ServingInt8Context(act_scales=act_scales_from_jax(act_scales or {}), calibrate=True)
    codes, real = [], ic.int8_conv_dequant

    def capture(x_q, *args, **kw):
        codes.append(x_q.permute(0, 2, 3, 1).numpy().copy())
        return real(x_q, *args, **kw)

    ic.int8_conv_dequant = capture
    try:
        got = torch.func.functional_call(serving.pair.model.features[idx], params, (x, ctx))
    finally:
        ic.int8_conv_dequant = real
    in_ch, out_ch, stride, t, sites = serving.pair.j_model.block_specs[idx - 1]
    j_ctx = JServingInt8Context(act_scales=act_scales, calibrate=True)
    with jax.disable_jit():
        want = JInvertedResidual(in_ch, out_ch, stride, t, False, sites).apply(
            {'params': serving.j_sp[f'features_{idx}']},
            jnp.asarray(x.permute(0, 2, 3, 1).numpy()), j_ctx)
    return (got.permute(0, 2, 3, 1).numpy(), ctx.recorded, codes), (np.asarray(want),
                                                                    j_ctx.recorded)


@pytest.mark.parametrize('idx', [1, 2, 3, 14],
                         ids=['t1_no_expand', 'stride2', 'residual', 'stride2_c576'])
def test_teacher_forced_depthwise_block_matches_eager_jax(serving, block_inputs, idx,
                                                          record_property):
    """One inverted-residual block (expand GEMM, its BN, the depthwise conv
    with its per-channel scale vector, its live BN, the project GEMM and BN)
    against eager JAX on the same float input and the same prepared codes.
    Dynamic, channel by channel with no absolute slack (a channel that is dead
    after ReLU6 holds the 1e-8 floor on both sides): the scale and abs-max of
    the block's first conv, which is fed the shared input, within 1e-6
    relative; in the block without an expand conv that is the depthwise
    vector itself.  Behind a conv and its live BN, ``(x - mean) * inv + bias``
    cancels and the two packages round it in another order: those scales
    within 1e-5.  E|x| within 1e-5 (summing order), the percentile within 1e-4
    (the interpolation weight is rounded differently).  Frozen at
    JAX's recorded scales: nothing recorded, and the depthwise conv is fed the
    codes the dynamic run made.  Either output agrees with JAX's within
    ``BLOCK_TOL``, which a wrong channel's scale would not."""
    x = block_inputs[idx]
    (got, rec, codes), (want, j_rec) = _block(serving, idx, x)
    assert set(rec) == set(j_rec)
    vectors = [k for k, v in j_rec.items() if '/' not in k and np.ndim(v) == 1]
    assert len(vectors) == 1
    first = min(frozen_keys := [k for k in j_rec if '/' not in k],
                key=lambda k: int(k[4:].split('_')[0]))
    for k, v in j_rec.items():
        if k.endswith('/pq'):
            rtol = 1e-4
        elif k.endswith('/b'):
            rtol = 1e-5
        else:
            rtol = 1e-6 if k.split('/')[0] == first else 1e-5
        np.testing.assert_allclose(rec[k].numpy(), np.asarray(v), rtol=rtol, atol=0, err_msg=k)
    if idx == 1:
        assert first == vectors[0]   # the depthwise vector itself is held to 1e-6
    dw = rec[vectors[0]].numpy()
    assert dw.shape == (codes[0].shape[-1],) and len(np.unique(dw)) > 1
    record_property(f'mobilenet_block{idx}_dynamic_rel', _rel(got, want))
    assert got.shape == want.shape and _rel(got, want) <= BLOCK_TOL

    frozen = {k: j_rec[k] for k in frozen_keys}
    (got_f, rec_f, codes_f), (want_f, j_rec_f) = _block(serving, idx, x, act_scales=frozen)
    assert rec_f == {} and j_rec_f == {}
    record_property(f'mobilenet_block{idx}_frozen_rel', _rel(got_f, want_f))
    assert _rel(got_f, want_f) <= BLOCK_TOL
    # frozen at the dynamic run's own scales: the same codes, the same output
    assert len(codes_f) == len(codes) == 1 and np.array_equal(codes_f[0], codes[0])
    assert np.abs(codes[0]).max() == 127
    np.testing.assert_array_equal(got_f, got)
