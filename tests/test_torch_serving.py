"""The port's true-int8 serving path against the JAX package: resnet18 at
64x64 on the CPU (plain versions of the kernels), the same BN-folded weights
and numpy-seeded inputs in both.

The JAX side runs op by op (``jax.disable_jit``) wherever a result is held to
a tight tolerance.  Under ``jit`` XLA rewrites the float arithmetic around the
exact integer sums: the division by the constant qmax becomes a multiplication
by its reciprocal and the epilogue's multiply and add contract into one
rounding.  Either moves a value by one ulp, which flips a code that sits on a
rounding tie (weights already on a fake-quant grid have many), and one flipped
code moves every abs-max behind it.  The port divides and rounds each
operation, on the CPU as on the card, as the un-jitted JAX ops do.

Tolerances and their reasons:

  * prepared codes **equal** and ``w_scale`` within 1e-6 (un-jitted JAX);
  * frozen scales within 1e-5 relative (un-jitted JAX; the sums for E|x| run
    in another order);
  * with JAX's prepared tree and frozen scales carried across by the weight
    bridge, each conv's output (teacher-forced: both convs get the port's
    input) within 1e-5 relative, and the W8A8 logits within 1e-2 relative of
    the un-jitted JAX forward with equal argmax: the integer sums are exact,
    but the float stem sums in another order, so a code may flip by one step.
    Against the jitted JAX forward the same logits are held to the serving
    path's own error budget (0.03, ``tests/test_serving_int8.py``), since
    there a flipped code is the rule.  W4A4 is reported.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu.cli.inference_sim import main as j_main
from cnn_quantization_tpu.ops.kernels.int_conv import int8_conv as j_int8_conv

from cnn_quantization_tpu_torch.cli.inference_sim import main
from cnn_quantization_tpu_torch.engine.context import (CollectContext, QuantizeContext,
                                                        ServingInt8Context, TapContext)
from cnn_quantization_tpu_torch.engine.evaluate import evaluate
from cnn_quantization_tpu_torch.models import build_model, layers, resnet
from cnn_quantization_tpu_torch.models.layers import PackedQTensor, QConv, QTensor
from cnn_quantization_tpu_torch.ops.kernels import int_conv as ic
from cnn_quantization_tpu_torch.ops.kernels import int_matmul as im
from cnn_quantization_tpu_torch.utils.flax_params import (act_scales_from_jax,
                                                          state_dict_from_flax)

from _torch_parity import JEngine, JPolicy, Pair, QuantEngine, QuantPolicy, torchvision_like_state

ARCH, SIZE = 'resnet18', 64
GRIDS = {'w8a8': 'int8', 'w4a4': 'int4'}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope='module')
def pair():
    return Pair(ARCH, SIZE)


@pytest.fixture(scope='module')
def batches():
    rng = np.random.RandomState(0)
    return [(rng.rand(2, SIZE, SIZE, 3).astype(np.float32), np.zeros(2, np.int32))
            for _ in range(2)]


class Serving:
    """Both engines on one grid, JAX's weight pass shared through the bridge
    (the jitted JAX weight pass differs from its own eager ops at a few
    weights; the serving path is what is compared here)."""

    def __init__(self, pair, qtype):
        kw = dict(qtype=qtype, qweight=qtype)
        self.j_eng = JEngine(pair.j_model, JPolicy(arch=ARCH, **kw), pair.j_meta)
        self.eng = QuantEngine(pair.model, QuantPolicy(arch=ARCH, **kw), pair.meta)
        self.j_pq = self.j_eng.quantize_params(pair.j_params)
        self.pq = state_dict_from_flax(self.j_pq)
        self.j_sp = self.j_eng.prepare_serving_params(self.j_pq)
        self.sp = state_dict_from_flax(self.j_sp)   # JAX's codes, carried across


@pytest.fixture(scope='module')
def serving(pair):
    return {name: Serving(pair, q) for name, q in GRIDS.items()}


@pytest.mark.parametrize('grid', sorted(GRIDS))
@pytest.mark.parametrize('s2d', [False, True], ids=['float_stem', 's2d_stem'])
def test_prepare_serving_params_codes_equal(serving, grid, s2d):
    s = serving[grid]
    with jax.disable_jit():
        want = state_dict_from_flax(s.j_eng.prepare_serving_params(s.j_pq, s2d_stem=s2d))
    got = s.eng.prepare_serving_params(s.pq, s2d_stem=s2d)
    assert set(got) == set(want)
    qmax = 127 if grid == 'w8a8' else 7
    for k, v in got.items():
        if k.endswith('.w_scale'):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
        else:
            assert v.dtype == want[k].dtype, k
            assert torch.equal(v, want[k]), k
            if v.dtype == torch.int8 and v.ndim == 4:
                assert v.permute(0, 2, 3, 1).is_contiguous(), k   # K contiguous
                if not k.startswith('conv1.'):
                    assert int(v.abs().max()) == qmax, k
    stem = got['conv1.weight']
    if s2d:
        assert stem.dtype == torch.int8 and tuple(stem.shape) == (64, 12, 4, 4)
        assert int(stem.abs().max()) == 127   # the stem stays 8-bit
        assert tuple(got['conv1.w_scale'].shape) == (64,)
    else:
        assert stem.dtype == torch.float32 and 'conv1.w_scale' not in got
    assert got['fc.weight'].dtype == torch.int8 and int(got['fc.weight'].abs().max()) == 127


def test_prepared_tree_leaves_float_state_dict_strict(pair, serving):
    """``w_scale`` is a key only the prepared tree carries: the module still
    loads a float tree strictly and has no such attribute outside a call."""
    pair.model.load_state_dict(state_dict_from_flax(pair.j_params), strict=True)
    assert not any(hasattr(m, 'w_scale') for m in pair.model.modules())
    assert sum(k.endswith('.w_scale') for k in serving['w8a8'].sp) == 20


@pytest.mark.parametrize('mode', ['max', 'percentile', 'aciq'])
@pytest.mark.parametrize('grid', sorted(GRIDS))
def test_freeze_serving_scales_match_jax(serving, batches, grid, mode):
    s = serving[grid]
    with jax.disable_jit():
        want = s.j_eng.freeze_serving_scales(s.j_sp, batches, mode=mode, percentile=99.5)
    got = s.eng.freeze_serving_scales(s.sp, batches, mode=mode, percentile=99.5)
    assert set(got) == set(want)
    assert sum(k.endswith(':out') for k in got) == 3   # layers 2-4 downsample
    assert 'conv0_activation' not in got                # the float stem
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_freeze_serving_scales_s2d_stem_and_percentile_exact(serving, batches):
    """With the s2d stem the image itself is a quantized input: its frozen
    scale is the requested percentile of |image| on the full int8 grid."""
    s = serving['w4a4']
    sp = s.eng.prepare_serving_params(s.pq, s2d_stem=True)
    for q in (99.5, 99.99):
        scales = s.eng.freeze_serving_scales(sp, batches[:1], mode='percentile', percentile=q)
        expect = np.percentile(np.abs(batches[0][0]), q) / 127.0
        np.testing.assert_allclose(scales['conv0_activation'], expect, rtol=1e-5)
    with pytest.raises(ValueError, match='unknown serving calibration mode'):
        s.eng.freeze_serving_scales(sp, batches, mode='median')


def test_freeze_modes_produce_group_constant_vectors():
    """Grouped conv inputs record per-group statistics: all three modes
    freeze an [in_ch] vector constant within each group, as in the JAX
    package, and the frozen forward runs on it."""
    from cnn_quantization_tpu_torch.engine.context import Site
    from cnn_quantization_tpu_torch.engine.engine import ModelMeta

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c0 = QConv(3, 16, 3, 1, 1, site=Site('conv0_activation', 'activation'))
            self.c1 = QConv(16, 16, 3, 1, 1, groups=4,
                            site=Site('conv1_activation', 'activation'))

        def forward(self, x, ctx):
            return self.c1(torch.relu(self.c0(x, ctx)), ctx).mean(dim=(2, 3))

    model = layers.init_parameters(Toy(), 0).eval()
    eng = QuantEngine(model, QuantPolicy(arch='toy', qtype='int8', qweight='int8'),
                      ModelMeta(arch='toy', input_size=16))
    sp = eng.prepare_serving_params(dict(model.state_dict()))
    rng = np.random.RandomState(2)
    cal = [(rng.rand(2, 16, 16, 3).astype(np.float32), np.zeros(2, np.int32))]
    frozen = {m: eng.freeze_serving_scales(sp, cal, mode=m)
              for m in ('max', 'percentile', 'aciq')}
    for m, scales in frozen.items():
        v = scales['conv1_activation']
        assert v.shape == (16,) and v.dtype == np.float32, m
        g = v.reshape(4, 4)
        assert (g == g[:, :1]).all(), m
        out, aux = eng.make_forward(quantized='serving_int8', act_scales=scales)(
            sp, None, cal[0][0])
        assert aux == {} and bool(torch.isfinite(out).all()), m
    for m in ('percentile', 'aciq'):
        assert (frozen[m]['conv1_activation'] <= frozen['max']['conv1_activation'] + 1e-12).all()


def _jax_conv_on(call):
    """The JAX ``int8_conv`` on one recorded call of the port's."""
    x, w_codes, w_scale, bias, kw = call
    nhwc = lambda t: np.ascontiguousarray(t.permute(0, 2, 3, 1).numpy())  # noqa: E731
    scale = kw['act_scale']
    return np.asarray(j_int8_conv(
        jnp.asarray(nhwc(x)), jnp.asarray(w_codes.permute(2, 3, 1, 0).numpy()),
        jnp.asarray(w_scale.numpy()), None if bias is None else jnp.asarray(bias.numpy()),
        strides=kw['strides'], padding=kw['padding'], groups=kw['groups'],
        act_bits=kw['act_bits'], act_scale=None if scale is None else jnp.asarray(scale.numpy())))


@pytest.mark.parametrize('grid', sorted(GRIDS))
def test_frozen_serving_matches_jax_per_conv_and_end_to_end(serving, batches, grid,
                                                            monkeypatch, record_property):
    s = serving[grid]
    x = batches[0][0]
    j_fwd = None
    with jax.disable_jit():
        j_scales = s.j_eng.freeze_serving_scales(s.j_sp, batches)
        j_fwd = s.j_eng.make_forward(quantized='serving_int8', act_scales=j_scales)
        want, j_aux = j_fwd(s.j_sp, None, jnp.asarray(x))
    jitted, _ = jax.jit(j_fwd)(s.j_sp, None, jnp.asarray(x))
    calls = []
    real = ic.int8_conv

    def recording(x, w_codes, w_scale, bias=None, **kw):
        # each conv's float output, the value its epilogue then requantizes
        # or adds the block's identity to
        conv = {k: v for k, v in kw.items()
                if k not in ('fuse_relu', 'out_scale', 'out_bits', 'residual')}
        calls.append(((x, w_codes, w_scale, bias, conv), real(x, w_codes, w_scale, bias, **conv)))
        return real(x, w_codes, w_scale, bias, **kw)

    monkeypatch.setattr(ic, 'int8_conv', recording)
    got, aux = s.eng.make_forward(quantized='serving_int8',
                                  act_scales=act_scales_from_jax(j_scales))(s.sp, None, x)
    assert aux == {} and j_aux == {}   # every site frozen, nothing recorded
    assert len(calls) == 19            # every conv but the float stem
    worst = max(_rel(y.permute(0, 2, 3, 1).numpy(), _jax_conv_on(call)) for call, y in calls)
    assert worst <= 1e-5, worst
    rel = _rel(got.numpy(), want)
    same = bool((got.numpy().argmax(-1) == np.asarray(want).argmax(-1)).all())
    rel_jit = _rel(got.numpy(), jitted)
    record_property(f'{grid}_logits_rel', rel)
    record_property(f'{grid}_logits_rel_to_jitted', rel_jit)
    record_property(f'{grid}_argmax_equal', same)
    assert bool(torch.isfinite(got).all())
    if grid == 'w8a8':
        assert rel <= 1e-2 and same, (rel, same)
        assert rel_jit < 0.03, rel_jit


@pytest.mark.parametrize('grid', sorted(GRIDS))
def test_dynamic_serving_matches_jax_and_in_call_weights(serving, batches, grid):
    """No frozen scales: per-conv abs-max, recorded under the same site ids;
    and float params (weights quantized in the call) give what the prepared
    tree gives."""
    s = serving[grid]
    x = batches[0][0]
    with jax.disable_jit():
        want, j_rec = s.j_eng.make_forward(quantized='serving_int8')(
            s.j_sp, None, jnp.asarray(x))
    fwd = s.eng.make_forward(quantized='serving_int8')
    got, rec = fwd(s.sp, None, x)
    assert set(rec) == set(j_rec) and len(rec) == 20
    for k in rec:
        np.testing.assert_allclose(rec[k].numpy(), np.asarray(j_rec[k]), rtol=1e-5, err_msg=k)
    if grid == 'w8a8':
        assert _rel(got.numpy(), want) <= 1e-2
    own = s.eng.prepare_serving_params(s.pq)
    in_call, _ = fwd(s.pq, None, x)
    prepared, _ = fwd(own, None, x)
    torch.testing.assert_close(in_call, prepared, rtol=1e-5, atol=1e-5)


def test_serving_close_to_float_and_int8_resident(pair, serving, batches, monkeypatch):
    """Frozen W8A8 serving stays within the JAX test's 0.03 of the float
    logits of the same weights; the block input is quantized once (conv1 and
    the downsample conv of every block receive a QTensor, the downsample conv
    emits one) and the max-pool runs on codes."""
    s = serving['w8a8']
    x = batches[0][0]
    scales = s.eng.freeze_serving_scales(s.sp, batches)
    fp, _ = s.eng.make_forward(quantized=False)(s.pq, None, x)
    seen = {}
    real_conv, real_pool = QConv.forward, layers.QMaxPool.forward

    def conv(self, x, ctx, **kw):
        y = real_conv(self, x, ctx, **kw)
        seen[self.site.id] = (isinstance(x, QTensor), isinstance(y, QTensor))
        return y

    def pool(self, x, ctx):
        seen['maxpool'] = isinstance(x, QTensor) and x.codes.dtype == torch.int8
        return real_pool(self, x, ctx)

    monkeypatch.setattr(QConv, 'forward', conv)
    monkeypatch.setattr(layers.QMaxPool, 'forward', pool)
    got, _ = s.eng.make_forward(quantized='serving_int8', act_scales=scales)(s.sp, None, x)
    assert _rel(got.numpy(), fp.numpy()) < 0.03
    assert bool((got.argmax(-1) == fp.argmax(-1)).all())
    assert seen['maxpool']
    for name, mod in pair.model.named_modules():
        if isinstance(mod, QConv) and name.endswith(('.conv1', 'downsample.0')):
            assert seen[mod.site.id][0], f'{name} must receive codes'
        if isinstance(mod, QConv) and name.endswith('downsample.0'):
            assert seen[mod.site.id][1], f'{name} must emit codes'


def test_bridge_carries_prepared_tree_and_scales(serving):
    s = serving['w8a8']
    j_sp = s.j_eng.prepare_serving_params(s.j_pq, s2d_stem=True)
    sp = state_dict_from_flax(j_sp)
    assert sp['conv1.weight'].dtype == torch.int8
    assert tuple(sp['conv1.weight'].shape) == (64, 12, 4, 4)
    k = np.asarray(j_sp['layer1_0']['conv1']['kernel'])
    assert sp['layer1.0.conv1.weight'].dtype == torch.int8
    np.testing.assert_array_equal(sp['layer1.0.conv1.weight'].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sp['fc.weight'].numpy(), np.asarray(j_sp['fc']['kernel']).T)
    np.testing.assert_array_equal(sp['fc.w_scale'].numpy(), np.asarray(j_sp['fc']['w_scale']))
    scales = act_scales_from_jax({'a': np.float64(0.5), 'b': np.arange(4, dtype=np.float64)})
    assert scales['a'] == 0.5 and isinstance(scales['a'], float)
    assert scales['b'].dtype == np.float32 and scales['b'].shape == (4,)


def test_packed_serving_fails_loudly(pair, serving, batches):
    """Packed serving is ported (``tests/test_torch_packed_serving.py``); what
    it cannot honour still fails loudly: 8-bit activations under ``packed``,
    and a conv handed a packed residual, an ``out_spec`` or a fused ReLU off
    the packed path.  On this BasicBlock trunk ``packed`` itself is a no-op."""
    s = serving['w4a4']
    x = batches[0][0]
    scales = s.eng.freeze_serving_scales(s.sp, batches, packed=True)
    assert sum(k.endswith(':out:packed') for k in scales) == 3
    plain, _ = s.eng.make_forward(quantized='serving_int8', act_scales=scales)(s.sp, None, x)
    for packed in (True, (1, 3)):
        got, _ = s.eng.make_forward(quantized='serving_int8', act_scales=scales,
                                    packed=packed)(s.sp, None, x)
        assert torch.equal(got, plain)
    res = evaluate(s.eng, s.sp, batches, quantized='serving_int8', act_scales=scales,
                   packed=True)
    assert np.isfinite(res['loss'])
    s8 = serving['w8a8']
    with pytest.raises(ValueError, match='4-bit codes'):
        s8.eng.make_forward(quantized='serving_int8', packed=True)
    with pytest.raises(ValueError, match='4-bit codes'):
        evaluate(s8.eng, s8.sp, batches, quantized='serving_int8', packed=(1, 3))
    conv = pair.model.layer1[0].conv1
    x = torch.zeros(1, 64, 8, 8)
    ctx = ServingInt8Context()
    for kw in (dict(residual=PackedQTensor(x[:, :32].to(torch.int8), torch.tensor(1.0))),
               dict(fuse_relu=True)):
        with pytest.raises(ValueError, match='packed 1x1 GEMM path'):
            conv(x, ctx, **kw)
    for kw in (dict(out_spec=('int8', 1.0)), dict(fuse_relu=True)):
        with pytest.raises(ValueError, match='true-int serving path'):
            conv(x, layers.TapContext(), **kw)


CLI = ['--device', 'cpu', '-a', ARCH, '-b', '2', '--subset', '4', '--input_size', str(SIZE),
       '--data', '/nonexistent', '--qtype', 'int8', '-qw', 'int8', '--serving_int8']


def _cli_result(entry, argv, capsys):
    assert entry(argv) == 0
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize('extra', [[], ['--serving_cal', 'aciq', '--serving_s2d_stem']],
                         ids=['max', 'aciq_s2d'])
def test_cli_serving_int8_matches_jax_cli(tmp_path, monkeypatch, capsys, extra):
    """``--serving_int8`` end to end on synthetic data in both packages, from
    one torchvision-style checkpoint: the same top-1/top-5, the loss within
    1e-2 relative."""
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.delenv('IMAGENET_DIR', raising=False)
    monkeypatch.chdir(tmp_path)
    path = tmp_path / f'{ARCH}.pth'
    torch.save({k: torch.from_numpy(v) for k, v in torchvision_like_state(ARCH).items()}, path)
    argv = CLI + ['--weights', str(path)] + extra
    out, got = _cli_result(main, argv, capsys)
    assert 'serving-int8: calibrating frozen activation scales' in out
    _, want = _cli_result(j_main, argv, capsys)
    assert got['top1'] == want['top1'] and got['top5'] == want['top5']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-2)


def test_cli_s2d_stem_note_on_odd_input(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.chdir(tmp_path)
    argv = [a if a != str(SIZE) else '63' for a in CLI] + ['--serving_s2d_stem']
    out, res = _cli_result(main, argv, capsys)
    assert '--serving_s2d_stem requested but not applied (odd input size)' in out
    assert np.isfinite(res['loss'])


@pytest.mark.parametrize('kind', ['tap', 'collect', 'quantize'])
def test_contexts_off_the_serving_path_read_its_off_values(kind, monkeypatch):
    """``TapContext`` declares what the serving layers read, at its off
    values, and the other contexts inherit them: a forward under each reads
    them and never reaches a serving branch (every one of them raises
    here).  ``ServingInt8Context`` holds scales of its own."""
    model, meta = build_model(ARCH, device='cpu', seed=0, input_size=32)
    policy = QuantPolicy(arch=ARCH, qtype='int4', qweight='int4')
    ctx = {'tap': TapContext(), 'collect': CollectContext(per_channel=False),
           'quantize': QuantizeContext(policy)}[kind]
    assert (ctx.int8_serving, ctx.act_bits, ctx.weight_bits, ctx.calibrate, ctx.packed) \
        == (False, 8, 8, False, False)
    assert dict(ctx.act_scales) == {} and ctx.act_scales is TapContext.act_scales
    with pytest.raises(TypeError):
        ctx.act_scales['conv1_activation'] = 1.0    # read-only, never a shared dict
    assert ctx.record_scale('conv1_activation', 1.0) is None
    assert ctx.record_input_stats('conv1_activation', torch.ones(2)) is None
    assert ServingInt8Context().act_scales is not ServingInt8Context().act_scales

    def serving(*args, **kwargs):
        raise AssertionError('a serving branch ran off the serving path')

    for owner, name in ((QConv, '_serve'), (QConv, '_packed_gemm_1x1'), (ic, 'int8_conv'),
                        (im, 'int8_matmul_dequant'), (im, 'quantize_sym_codes'),
                        (resnet, 'quantize_sym_codes')):
        monkeypatch.setattr(owner, name, serving)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, 32, 32).astype(np.float32))
    logits = torch.func.functional_call(model, dict(model.state_dict()), (x, ctx))
    assert logits.shape == (2, 1000) and bool(torch.isfinite(logits).all())
