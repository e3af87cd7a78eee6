"""The three 4-bit recipes on the JAX ordering test's trained ResNet-18, held
to the JAX package by their float-order band.

A 4-bit recipe's top-1 on this network moves with the last bit of a float
sum: a code at a rounding tie flips and the flip compounds through the
trunk.  So one run of each package is one draw, and two runs that order
their sums differently differ by chaos.  The band measures that chaos:
``chip_smoke.accuracy_band`` nudges a fixed 30 % of every weight tensor's
elements up by one ulp (``chip_smoke.nudge_weights``, K = 12 numpy-seeded
draws, the same draws for both packages), runs the weight pass and the
evaluation of the 2048 test images at batch 256 on each, and keeps each
config's top-1 mean and sample sd.

Bars, per config (``naive_w4a4``, ``headline``, ``2std``):
  * the port's band mean (``QuantEngine`` on the CPU) within 3 combined
    standard errors (Welch: 3 * sqrt(sd_port^2/K + sd_jax^2/K)), and never
    less than 2 images, of the JAX package's band mean (its engine jitted,
    as its CLI runs it) and of the JAX package's band under
    ``jax.disable_jit()`` (eager: op by op, as the port runs);
  * the eager JAX CLI's top-1 within the jitted JAX band's mean +- 4 sd, and
    never less than 4 images.

Measured on an 8-core CPU (1285 s for the fixture's training, the bands and
the bars; the last two tests add 11 s and 221 s):

  top-1, K = 12    jitted JAX        eager JAX         port             eager CLI
  naive_w4a4       70.8415 +- 0.1702 70.8252 +- 0.3085 71.0531 +- 0.1995 70.9961
  headline         73.0143 +- 0.3778 72.7336 +- 0.2554 72.8678 +- 0.2431 73.9746
  2std             68.6930 +- 0.1058 68.4001 +- 0.3470 68.3512 +- 0.3877 68.0664

Every port bar holds.  On the parent's ``ops/bias_corr.py`` the port's
headline band was 73.0916 +- 0.2670, 0.3581 above eager JAX's against a
bar of 0.3200: the weight-pass repair below made it hold.  The last bar fails for ``2std``, and not through the
port: the jitted JAX band is narrow and sits above the eager one (68.6930 +-
0.1058 against 68.4001 +- 0.3470), so the eager JAX CLI's 68.0664 lies 5.9
sd below it, while the port's band agrees with both.  XLA's jitted weight
pass multiplies by 1/qmax where the eager ops divide: the jitted band is a
band around another weight pass.  The JAX package is the reference and stays as it is.

The eager JAX CLI's headline, 73.9746, lies 4.9 sd above eager JAX's own
band, and every package's unperturbed headline lies above its band: the
unperturbed network is not a typical draw of it.  Any one-ulp nudge, up,
down or toward zero, costs the headline top-1, and only with ``-bcw`` and
``-baa`` together (``test_headline_nudged_any_way_scores_below_unperturbed``).
So the bands compare the packages on nearby networks, and the unperturbed
runs are compared by the bisection below.

The bisection of the 28 images the port's headline CLI trailed eager JAX's
by (72.6074 against 73.9746), against eager JAX on the trained weights:
  a. the weight pass: every leaf of all three recipes bit-equal
     (``test_weight_pass_equals_eager_jax``).  Before this file's change the
     headline's bias correction (``-bcw``) summed its per-channel means with
     ``torch.mean``: 3,394,625 elements apart (29 %), at most 2 ulps of a
     leaf's largest |w|.  ``ops/bias_corr.py`` now sums in XLA's CPU order
     (windows of 32, ``xla_cpu_sum``) and divides by the count, as eager
     ``jnp.mean`` does (under jit XLA multiplies by 1/n instead).  The
     port's headline CLI now scores 73.4375: 17 of the 28 images;
  b. the swap: the port's forward on eager JAX's quantized weights scores
     as on its own, since they are the same bits (it was 17 images apart);
  c. the activation path, free running on one batch of 256: the first
     site's input (the stem conv's output) is bit-equal in both packages;
     that site's per-channel clip values differ by up to 1.5e-6 relative in
     57 of its 64 channels, which flips 2 codes of 4,194,304, and the flips
     compound to 23 % of the classifier input's codes.  Teacher forced (the
     port's quantizer on JAX's own input at every site) the per-channel bit
     widths are equal everywhere and the clip values within 2e-6 relative
     (``test_activation_path_free_running``);
  d. the op: the per-channel statistics of ``ops/stats.py`` (the mean, the
     Laplace ``b``, the std of the Gaussian-prior bit allocation) sum over
     N*H*W with ``torch``'s reductions; eager XLA sums in windows of 32
     along the batch, each window's 32*H*W elements one after another
     (8192 at the stem's 16x16 maps).  With the statistics summed in that
     order (``_xla_order_reduce_stats``, here only) the stem's and the max
     pool's sites are bit-equal, the forwards first part at the next conv
     (``torch``'s float conv sums in another order than XLA's), and the
     headline scores 74.0234 against eager JAX's 73.9746: the other 11
     images (``test_activation_path_with_xla_order_statistics``).  The
     port keeps its own reductions: XLA's order is a chain of 8192
     dependent additions a window, a kernel of its own on the card, its
     sums are the less exact ones (1e-5 against the port's 1e-7 of the
     float64 value, ``tests/test_torch_weight_pass_trained_like.py``), and
     the port's band agrees with both JAX bands.

Runtime: ~25 min on an 8-core CPU.  Gated behind ``CNNQ_RUN_SLOW=1`` as the
JAX ordering test is:

    CNNQ_RUN_SLOW=1 JAX_PLATFORMS=cpu python -m pytest \\
        tests/test_torch_accuracy_band_slow.py -q -s
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cnn_quantization_tpu.cli import inference_sim as j_cli
from cnn_quantization_tpu.engine import QuantEngine as JEngine
from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
from cnn_quantization_tpu.engine import context as j_context
from cnn_quantization_tpu.engine.evaluate import make_eval_step
from cnn_quantization_tpu.models import build_model as j_build_model
from cnn_quantization_tpu.ops import quantizer as j_quantizer
from cnn_quantization_tpu_torch.engine import QuantEngine
from cnn_quantization_tpu_torch.engine import context as p_context
from cnn_quantization_tpu_torch.engine.evaluate import evaluate
from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.ops import quantizer as p_quantizer
from cnn_quantization_tpu_torch.ops import stats as p_stats
from cnn_quantization_tpu_torch.ops.bias_corr import xla_cpu_sum
from cnn_quantization_tpu_torch.utils.checkpoint import load_params_npz
from cnn_quantization_tpu_torch.utils.flax_params import (flax_from_state_dict,
                                                          state_dict_from_flax)
from _torch_cli_pair import run
from test_accuracy_ordering import trained_assets  # noqa: F401  (a fixture)

pytestmark = pytest.mark.skipif(
    not os.environ.get('CNNQ_RUN_SLOW'),
    reason='trains a ResNet-18 and runs 12 draws of 3 recipes through both packages for '
           '~25 min; set CNNQ_RUN_SLOW=1 to run')

DRAWS = 12
BATCH = 256
CONFIGS = chip_smoke.BAND_CONFIGS


@pytest.fixture(autouse=True)
def _no_imagenet(monkeypatch):
    monkeypatch.delenv('IMAGENET_DIR', raising=False)


@pytest.fixture(scope='module')
def assets(trained_assets):  # noqa: F811
    """(state dict in the port's layout as C-contiguous numpy, the JAX tree,
    test images, labels)."""
    wpath, dpath = trained_assets
    tree = load_params_npz(wpath)
    state = {k: np.ascontiguousarray(v.numpy())
             for k, v in state_dict_from_flax(tree, 'resnet18').items()}
    with np.load(dpath) as z:
        return state, tree, z['images'], z['labels']


def jax_band_scorer(images, labels, eager):
    """``score`` of ``chip_smoke.accuracy_band`` on the JAX package: its
    weight pass and eval step (jitted, or under ``jax.disable_jit()``) on the
    state converted to its tree, summing the top-k counts."""
    j_model, j_meta = j_build_model('resnet18')
    steps = {}

    def score(state, name):
        if name not in steps:
            policy = dataclasses.asdict(chip_smoke.ordering_policy(name))
            eng = JEngine(j_model, JPolicy(**policy), j_meta)
            steps[name] = (eng, make_eval_step(eng))
        eng, step = steps[name]
        tree = flax_from_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                    'resnet18')
        with jax.disable_jit(eager):
            pq = eng.quantize_params(tree)
            top1 = top5 = 0
            for i in range(0, len(images), BATCH):
                out = step(pq, None, jnp.asarray(images[i:i + BATCH]),
                           jnp.asarray(labels[i:i + BATCH]))
                top1, top5 = top1 + int(out['top1']), top5 + int(out['top5'])
        return 100.0 * top1 / len(images), 100.0 * top5 / len(images)

    return score


@pytest.fixture(scope='module')
def bands(assets):
    state, _, images, labels = assets
    model, meta = build_model('resnet18', device='cpu')
    out = {'port': chip_smoke.accuracy_band(
        chip_smoke.port_band_scorer(model, meta, images, labels, BATCH, torch.device('cpu')),
        state, DRAWS)}
    for kind, eager in (('jax', False), ('eager_jax', True)):
        out[kind] = chip_smoke.accuracy_band(jax_band_scorer(images, labels, eager), state,
                                             DRAWS)
    for name in CONFIGS:
        print(f'\n{name} top-1 band, K = {DRAWS}: ' + ', '.join(
            f"{kind} {b[name]['top1']['mean']:.4f} +- {b[name]['top1']['sd']:.4f} "
            f"[{b[name]['top1']['min']:.4f}, {b[name]['top1']['max']:.4f}] "
            f"(unperturbed {b[name]['unperturbed']:.4f})" for kind, b in out.items()))
    return out


def welch_bar(a, b, n_images):
    """3 combined standard errors of two band means, and never less than 2
    images."""
    se = math.sqrt(a['sd'] ** 2 / DRAWS + b['sd'] ** 2 / DRAWS)
    return max(3.0 * se, 100.0 * 2 / n_images)


@pytest.mark.parametrize('reference', ['jax', 'eager_jax'])
@pytest.mark.parametrize('name', CONFIGS)
def test_port_band_mean_matches_jax_band(bands, assets, name, reference):
    port, ref = bands['port'][name]['top1'], bands[reference][name]['top1']
    bar = welch_bar(port, ref, len(assets[2]))
    assert abs(port['mean'] - ref['mean']) <= bar, (name, reference, port, ref, bar)


@pytest.mark.parametrize('name', CONFIGS)
def test_eager_jax_cli_within_jax_band(bands, trained_assets, name, tmp_path,  # noqa: F811
                                       monkeypatch):
    wpath, dpath = trained_assets
    argv = (['--device', 'cpu', '-a', 'resnet18', '-b', str(BATCH), '--data', dpath,
             '--weights', wpath] + chip_smoke.ORDERING_CONFIGS[name])
    with jax.disable_jit():
        rc, _, res = run(j_cli.main, argv, tmp_path, monkeypatch)
    assert rc == 0 and res is not None
    band = bands['jax'][name]['top1']
    held, half = chip_smoke.band_holds(band, res['top1'], 2048)
    print(f"\n{name}: eager JAX CLI top-1 {res['top1']}, jitted JAX band {band['mean']:.4f} "
          f"+- {half:.4f}")
    assert held, (name, res['top1'], band, half)


def _port_engine(name):
    model, meta = build_model('resnet18', device='cpu')
    return QuantEngine(model, chip_smoke.ordering_policy(name), meta)


@pytest.mark.parametrize('name', CONFIGS)
def test_weight_pass_equals_eager_jax(assets, name):
    """Steps a and b: every leaf bit-equal to the eager JAX weight pass, so the
    port's forward scores the same on either package's quantized weights."""
    state, tree, images, labels = assets
    j_model, j_meta = j_build_model('resnet18')
    j_eng = JEngine(j_model, JPolicy(**dataclasses.asdict(chip_smoke.ordering_policy(name))),
                    j_meta)
    with jax.disable_jit():
        want = state_dict_from_flax(jax.device_get(j_eng.quantize_params(tree)), 'resnet18')
    eng = _port_engine(name)
    got = eng.quantize_params({k: torch.from_numpy(v) for k, v in state.items()})
    apart = {k: int((got[k] != want[k]).sum()) for k in got}
    assert not any(apart.values()), {k: n for k, n in apart.items() if n}
    batches = [(images[i:i + BATCH], labels[i:i + BATCH]) for i in range(0, 512, BATCH)]
    own = evaluate(eng, got, batches)
    swapped = evaluate(eng, {k: v.contiguous() for k, v in want.items()}, batches)
    assert own['top1'] == swapped['top1'] and own['loss'] == swapped['loss']


def _nhwc(t):
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _record_forwards(state, tree, images):
    """Both eager headline forwards on ``images``: per package ('jax',
    'port'), each site's (pre-quantization input, output, config) in forward
    order, as NHWC numpy."""
    policy = chip_smoke.ordering_policy('headline')
    seen = {'jax': {}, 'port': {}}

    def recorder(mp, cls, kind, to_numpy):
        real = cls.tap

        def tap(self, x, site):
            out = real(self, x, site)
            seen[kind][site.id] = (to_numpy(x), to_numpy(out), self.config_for(site))
            return out
        mp.setattr(cls, 'tap', tap)

    with pytest.MonkeyPatch.context() as mp:
        recorder(mp, j_context.QuantizeContext, 'jax', np.asarray)
        recorder(mp, p_context.QuantizeContext, 'port', _nhwc)
        j_model, j_meta = j_build_model('resnet18')
        j_eng = JEngine(j_model, JPolicy(**dataclasses.asdict(policy)), j_meta)
        with jax.disable_jit():
            j_eng.make_forward()(j_eng.quantize_params(tree), None, jnp.asarray(images))
        eng = _port_engine('headline')
        with torch.no_grad():
            eng.make_forward()(eng.quantize_params({k: torch.from_numpy(v)
                                                    for k, v in state.items()}), None, images)
    assert list(seen['port']) == list(seen['jax']) and len(seen['jax']) == 23
    return seen


def _flips(op, oj):
    """Output elements further from JAX's than 1e-4 of the site's largest."""
    return int((np.abs(op - oj) > 1e-4 * np.abs(oj).max()).sum())


def test_activation_path_free_running(assets):
    """Step c: both eager headline forwards on one batch of 256, each site's
    pre-quantization input and output recorded in forward order; per site
    the relative error of both, the codes flipped (an output element further
    from JAX's than 1e-4 of the site's largest value) and, at the
    per-channel sites, the bit widths and clip values each package derives
    from its own input and the port's from JAX's input (teacher forced)."""
    state, tree, images, _ = assets
    seen = _record_forwards(state, tree, images[:BATCH])

    def derived_j(x, cfg):
        with jax.disable_jit():
            xa = jnp.asarray(x)
            bits = j_quantizer._act_bit_alloc(cfg, xa, None, -1)
            alpha = j_quantizer._alpha(cfg, xa, None, half_range=False, per_channel=True,
                                       channel_axis=-1)
        return np.asarray(bits), np.asarray(alpha)

    def derived_p(x, cfg):
        t = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
        bits = p_quantizer._act_bit_alloc(cfg, t, None, 1)
        alpha = p_quantizer._alpha(cfg, t, None, half_range=False, per_channel=True,
                                   channel_axis=1)
        return bits.numpy(), alpha.numpy()

    first_parting, rows = None, []
    for sid, (xj, oj, cj) in seen['jax'].items():
        xp, op, cp = seen['port'][sid]
        flips = _flips(op, oj)
        row = dict(site=sid, rel_in=float(np.linalg.norm(xp - xj) / np.linalg.norm(xj)),
                   rel_out=float(np.linalg.norm(op - oj) / np.linalg.norm(oj)), flips=flips)
        if xj.ndim == 4 and xj.shape[1] * xj.shape[2] > 1 and cj.bit_alloc_act \
                and cj.num_bits <= 4:
            bits_j, alpha_j = derived_j(xj, cj)
            bits_p, alpha_p = derived_p(xp, cp)
            bits_tf, alpha_tf = derived_p(xj, cp)
            row.update(bits_apart=int((bits_p != bits_j).sum()),
                       bits_apart_tf=int((bits_tf != bits_j).sum()),
                       alpha_apart_tf=int((alpha_tf != alpha_j).sum()),
                       alpha_rel_tf=float(np.max(np.abs(alpha_tf - alpha_j) / np.abs(alpha_j))))
            assert row['bits_apart_tf'] == 0, row
            assert row['alpha_rel_tf'] <= 2e-6, row
        if first_parting is None and flips:
            first_parting = row
        rows.append(row)
        print(row)
    print(f'first site where the forwards part: {first_parting}')
    # the first site's input is the stem conv's output: bit-equal
    assert rows[0]['site'] == 'conv0_activation' and rows[0]['rel_in'] == 0.0
    assert first_parting is not None


def _xla_order_mean(t, dims, divisor=None):
    """``t``'s mean over ``dims`` (keepdim) summed as eager ``jnp.mean`` sums
    it on the CPU: a 4-d NCHW activation in the JAX package's NHWC layout,
    every reduced dim ahead of the kept ones, through ``xla_cpu_sum``."""
    dims = sorted(d % t.ndim for d in dims)
    perm = [0, 2, 3, 1] if t.ndim == 4 else list(range(t.ndim))
    k = t.permute(perm)
    red = [perm.index(d) for d in dims]
    red.sort()
    kept = [i for i in range(k.ndim) if i not in red]
    x = k.permute(red + kept)
    n = math.prod(k.shape[i] for i in red)
    s = xla_cpu_sum(x.reshape([k.shape[i] for i in red] + [-1]))
    keep = [1 if i in red else k.shape[i] for i in range(k.ndim)]
    m = (s / torch.full((), float(n if divisor is None else divisor))).reshape(keep)
    return m.permute([perm.index(i) for i in range(t.ndim)])


def _xla_order_reduce_stats(t, stats, dims, group=None):
    """``ops/stats._reduce_stats`` (no data group) with its sums in XLA's
    CPU order: the mean, the Laplace ``b`` and the std."""
    assert group is None
    mean = _xla_order_mean(t, dims)
    n = math.prod(t.shape[d] for d in dims)
    out = {}
    for s in stats:
        if s == 'min':
            out[s] = torch.amin(t, dim=dims)
        elif s == 'max':
            out[s] = torch.amax(t, dim=dims)
        elif s == 'mean':
            out[s] = mean.squeeze(dims)
        elif s == 'b':
            out[s] = _xla_order_mean(torch.abs(t - mean), dims).squeeze(dims)
        elif s == 'std':
            var = _xla_order_mean((t - mean) ** 2, dims, n - 1)
            out[s] = torch.sqrt(var.double()).float().squeeze(dims)
        else:
            raise ValueError(f'no XLA-order stand-in for {s!r}')
    return out


@pytest.fixture
def xla_order_statistics(monkeypatch):
    """The port's activation statistics summed in XLA's CPU order for one
    test: ``_xla_order_reduce_stats`` for ``ops/stats._reduce_stats``, and
    the batch mean of per-sample statistics through ``_xla_order_mean``."""
    monkeypatch.setattr(p_stats, '_reduce_stats', _xla_order_reduce_stats)
    monkeypatch.setattr(p_stats, '_batch_mean',
                        lambda per_sample, n: {k: _xla_order_mean(v, (0,)).squeeze(0)
                                               for k, v in per_sample.items()})


def test_activation_path_with_xla_order_statistics(assets, bands, xla_order_statistics):
    """Step d, confirmed: the port with its activation statistics summed in
    XLA's CPU order (the fixture ``xla_order_statistics``, here only).  On one
    batch the stem's site and the max pool's are bit-equal to eager JAX's,
    and the forwards first part at ``conv1_activation`` on a bit-equal
    input: ``torch``'s float conv sums in another order than XLA's.  On the
    2048 images the port's headline then scores within 2 images of eager
    JAX's (measured: 74.0234 against 73.9746; 73.4375 with the port's own
    statistics)."""
    state, tree, images, labels = assets
    seen = _record_forwards(state, tree, images[:BATCH])
    sites = list(seen['jax'])
    apart = {sid: (int((seen['port'][sid][0] != seen['jax'][sid][0]).sum()),
                   int((seen['port'][sid][1] != seen['jax'][sid][1]).sum())) for sid in sites}
    print({sid: (*a, _flips(seen['port'][sid][1], seen['jax'][sid][1]))
           for sid, a in apart.items()})
    assert sites[:3] == ['conv0_activation', 'maxpool0_out', 'conv1_activation']
    assert apart['conv0_activation'] == apart['maxpool0_out'] == (0, 0)
    assert apart['conv1_activation'][0] > 0
    model, meta = build_model('resnet18', device='cpu')
    top1, _ = chip_smoke.port_band_scorer(model, meta, images, labels, BATCH,
                                          torch.device('cpu'))(state, 'headline')
    eager = bands['eager_jax']['headline']['unperturbed']
    print(f'headline with XLA-order statistics: port {top1:.4f}, eager JAX {eager:.4f}')
    assert abs(top1 - eager) <= 100.0 * 2 / len(images), (top1, eager)


def test_headline_nudged_any_way_scores_below_unperturbed(assets, xla_order_statistics):
    """Why the unperturbed headline lies above its band in every package: the
    port as eager JAX runs it (statistics in XLA's order, as above), the
    headline on the unperturbed weights and on 4 draws each of one-ulp
    nudges of 30 % of the elements up, down and toward zero.  Every one of
    the 12 draws scores below the unperturbed run, which lies 3 sd or more
    above their mean (measured: 74.0234 against 72.7661 +- 0.3096, z 4.06).
    Without ``-bcw`` or without ``-baa`` the unperturbed run lies within 2
    sd of 4 draws nudged up: the unperturbed network is special only to the
    two together, and the band, a band of nearby networks, is not centred on
    it."""
    state, _, images, labels = assets
    model, meta = build_model('resnet18', device='cpu')
    batches = [(images[i:i + BATCH], labels[i:i + BATCH]) for i in range(0, len(images), BATCH)]

    def nudged(draw, toward):
        rs = np.random.RandomState(draw)
        out = {}
        for name in sorted(state):
            w = np.array(state[name], order='C')
            if w.ndim >= 2:
                flat = w.reshape(-1)
                idx = rs.choice(flat.size, int(chip_smoke.BAND_SHARE * flat.size), replace=False)
                flat[idx] = np.nextafter(flat[idx], np.float32(toward))
            out[name] = w
        return out

    def top1(policy, st):
        eng = QuantEngine(model, policy, meta)
        params = eng.quantize_params({k: torch.from_numpy(v) for k, v in st.items()})
        return evaluate(eng, params, batches)['top1']

    def z_score(name, policy, directions):
        base = top1(policy, state)
        draws = np.array([top1(policy, nudged(k, toward))
                          for toward in directions for k in range(4)])
        z = (base - draws.mean()) / draws.std(ddof=1)
        print(f'{name}: unperturbed {base:.4f}, nudged {draws.tolist()} '
              f'(mean {draws.mean():.4f}, sd {draws.std(ddof=1):.4f}, z {z:.2f})')
        return base, draws, z

    headline = chip_smoke.ordering_policy('headline')
    base, draws, z = z_score('headline', headline, (np.inf, -np.inf, 0.0))
    assert draws.max() < base and z >= 3.0, (base, draws)
    for name, change in (('no_bcw', dict(bias_corr_weight=False)),
                         ('no_baa', dict(bit_alloc_act=False))):
        _, _, z = z_score(name, dataclasses.replace(headline, **change), (np.inf,))
        assert abs(z) <= 2.0, (name, z)
