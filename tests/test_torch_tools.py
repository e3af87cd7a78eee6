"""The port's auxiliary tools against the JAX package's: the STE and the
optimizer regime (tests/test_optim_ste.py's values), the analysis scripts
(analytic against simulated, tests/test_analysis.py's bars; the closed forms
equal), the bias-correction study, the k-means CLI, the inverse weight bridge
and the golden runbook.

Tolerances: the STE forward equal to the plain fake-quant and to JAX's
(1e-6 relative, as the JAX test), its gradient exact; the optimizer's update
-0.001 to 1e-6 relative; the analysis curves at the JAX tests' bars;
``channel_bias`` within 1e-5 of JAX's (normalized biases; the two packages'
per-channel quantizers agree to rounding); k-means skips exactly the leaves
JAX skips, gives at most 2^bits values a leaf, and an inertia at most 1.05x
scikit-learn's.
"""

import numpy as np
import pytest
import torch

from cnn_quantization_tpu.analysis import bias_correction as j_bias
from cnn_quantization_tpu.analysis import bit_alloc_synthetic as j_ba
from cnn_quantization_tpu.analysis import mse_analysis as j_mse
from cnn_quantization_tpu.cli import kmeans_quantization as j_kmeans
from cnn_quantization_tpu.ops import aciq as j_aciq

from cnn_quantization_tpu_torch.analysis import bias_correction, bit_alloc_synthetic, mse_analysis
from cnn_quantization_tpu_torch.cli import golden_repro
from cnn_quantization_tpu_torch.cli import kmeans_quantization as kmeans
from cnn_quantization_tpu_torch.models import available_archs, build_model
from cnn_quantization_tpu_torch.ops import quant_math
from cnn_quantization_tpu_torch.ops.kernels import fake_quant as fq
from cnn_quantization_tpu_torch.ops.ste import (attach, fake_quant_ste, fake_quant_ste_mask,
                                                straight_through)
from cnn_quantization_tpu_torch.utils.flax_params import flax_from_state_dict, state_dict_from_flax
from cnn_quantization_tpu_torch.utils.optim import OptimRegime, lr_schedule

REGIME = [{'epoch': 0, 'optimizer': 'sgd', 'lr': 0.1, 'momentum': 0.9},
          {'epoch': 2, 'lr': 0.01},
          {'epoch': 4, 'lr': 0.001, 'momentum': 0.0}]


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs six test files at once
    yield
    torch.set_num_threads(n)


def test_lr_schedule_boundaries():
    sched = lr_schedule(REGIME, steps_per_epoch=10)
    vals = [sched(s) for s in (0, 5, 19, 20, 39, 40, 100)]
    np.testing.assert_allclose(vals, [0.1, 0.1, 0.1, 0.01, 0.01, 0.001, 0.001], rtol=1e-6)


def test_optim_regime_settings_and_transform():
    reg = OptimRegime(REGIME, steps_per_epoch=1)
    assert reg.setting['lr'] == 0.1 and reg.setting['momentum'] == 0.9
    assert reg.update(3, 0) and reg.setting['lr'] == 0.01
    reg.update(4, 0)
    assert reg.setting['lr'] == 0.001 and reg.setting['momentum'] == 0.0
    # from zeros the parameter after one step is the update itself
    w = torch.zeros(3, requires_grad=True)
    opt = reg.transform([w])
    assert isinstance(opt, torch.optim.SGD)
    w.grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), -0.001 * np.ones(3), rtol=1e-6)
    # a later change retunes the same optimizer in place
    reg.rules.append((5, {'lr': 0.5}))
    reg.update(5, 0)
    assert reg.transform() is opt and opt.param_groups[0]['lr'] == 0.5


def test_attach_forward_and_backward():
    f = attach(forward_fn=lambda x: x * 2, backward_fn=lambda g: g * 3)
    x = torch.tensor(2.0, requires_grad=True)
    y = f(x)
    y.backward()
    assert float(y) == 4.0 and float(x.grad) == 3.0   # the backward functor, not 2


def test_straight_through_round():
    x = torch.tensor([0.3, 0.7], requires_grad=True)
    straight_through(torch.round)(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 1.0])


def test_fake_quant_ste_matches_jax_and_masks_grad():
    import jax
    import jax.numpy as jnp
    from cnn_quantization_tpu.ops.ste import fake_quant_ste as j_ste
    values = [-0.5, 0.1, 0.5, 0.9, 1.5]
    x = torch.tensor(values, requires_grad=True)
    out = fake_quant_ste(x, 1.0, 0.0, 15.0)
    want = j_ste(jnp.asarray(values), 1.0, 0.0, 15.0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(),
                               quant_math.fake_quant(x.detach(), 1.0, 0.0, 15.0).numpy(),
                               rtol=1e-6)
    out.sum().backward()
    j_grad = jax.grad(lambda v: jnp.sum(j_ste(v, 1.0, 0.0, 15.0)))(jnp.asarray(values))
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(j_grad))


def test_fake_quant_ste_per_channel():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 3, 3, generator=g).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    delta, offset = torch.rand(4, generator=g) + 0.5, -torch.rand(4, generator=g)
    out = fake_quant_ste(x, delta, offset, 15.0, channel_dim=1)
    torch.testing.assert_close(out, fq.fake_quant_fused_plain(x.detach(), delta, offset, 15.0,
                                                              channel_dim=1), rtol=0, atol=0)
    out.backward(torch.full_like(out, 2.0))
    mask = fake_quant_ste_mask(x.detach(), delta, offset, channel_dim=1)
    assert 0 < mask.sum() < mask.numel()
    torch.testing.assert_close(x.grad, 2.0 * mask, rtol=0, atol=0)


def test_laplace_analytic_matches_simulation():
    alphas, analytic, simulated = mse_analysis.compare('laplace', 4, n=200_000, device='cpu')
    j_alphas, j_analytic, _ = j_mse.compare('laplace', 4, n=1000)
    np.testing.assert_array_equal(alphas, j_alphas)
    np.testing.assert_allclose(analytic, j_analytic, rtol=1e-12)
    rel = np.abs(analytic - simulated) / np.maximum(analytic, 1e-9)
    assert np.median(rel) < 0.15
    a_min = alphas[int(np.argmin(simulated))]
    assert abs(a_min - j_aciq.ALPHA_LAPLACE[4] * 2.0) < 0.6, a_min


def test_gaussian_analytic_matches_simulation():
    alphas, analytic, simulated = mse_analysis.compare('gaus', 4, n=200_000, device='cpu')
    np.testing.assert_allclose(analytic, j_mse.compare('gaus', 4, n=1000)[1], rtol=1e-12)
    a_min = alphas[int(np.argmin(simulated))]
    assert abs(a_min - j_aciq.ALPHA_GAUS[4] * 2.0) < 0.6, a_min


def test_bit_alloc_rule_matches_simulation():
    fracs, mses = bit_alloc_synthetic.run(device='cpu')
    best = fracs[int(np.argmin(mses))]
    pred = bit_alloc_synthetic.optimal_fraction(2.82845653294, 1.0)
    assert pred == j_ba.optimal_fraction(2.82845653294, 1.0)
    assert abs(best - pred) < 0.08, (best, pred)
    j_fracs, j_mses = j_ba.run()
    assert abs(best - j_fracs[int(np.argmin(j_mses))]) < 0.08


def test_channel_bias_matches_jax():
    model, _ = build_model('resnet18', device='cpu', seed=1)
    params = {k: v for k, v in model.state_dict().items()
              if k.startswith(('conv1.', 'layer1.', 'layer2.0.'))}
    rows = bias_correction.channel_bias(params, num_bits=4)
    j_rows = j_bias.channel_bias(flax_from_state_dict(params, 'resnet18'), num_bits=4)
    # the stage-1 and first stage-2 convs but the stem; JAX paths join by '/'
    assert len(rows) == len(j_rows) == 7
    for path, (q, c) in rows.items():
        jq, jc = j_rows[_jax_path(path)]
        np.testing.assert_allclose(q, jq, atol=1e-5)
        np.testing.assert_allclose(c, jc, atol=1e-5)
        assert c.mean() < q.mean()


def _jax_path(torch_path):
    segs = []
    for s in torch_path.split('.'):
        if s.isdigit():
            segs[-1] += f'_{s}'
        else:
            segs.append(s)
    return '/'.join(segs)


@pytest.mark.parametrize('name', ['layer1.0.conv1.weight', 'layer2.0.downsample.0.weight',
                                  'layer3.1.conv2.weight'])
def test_kmeans_inertia_against_sklearn(name):
    from sklearn.cluster import KMeans
    w = dict(build_model('resnet18', device='cpu', seed=2)[0].state_dict())[name]
    centroids, index, inertia, _ = kmeans.kmeans1d(w, 16)
    assert centroids.numel() == 16 and torch.all(centroids[1:] > centroids[:-1])
    np.testing.assert_allclose(inertia, float(((w.double() - centroids.double()[index]) ** 2)
                                              .sum()), rtol=1e-9)
    km = KMeans(n_clusters=16, random_state=0, n_init=1).fit(w.reshape(-1, 1).numpy())
    assert inertia <= 1.05 * km.inertia_, (inertia, km.inertia_)
    # deterministic
    assert kmeans.kmeans1d(w, 16)[2] == inertia


def test_kmeans_few_distinct_values():
    centroids, index, inertia, _ = kmeans.kmeans1d(torch.tensor([1.0, 1.0, 1.0, 2.0]), 16)
    assert centroids.tolist() == [1.0, 2.0] and index.tolist() == [0, 0, 0, 1] and inertia == 0


@pytest.mark.parametrize('arch', ['resnet18', 'inception_v3'])
def test_kmeans_skips_what_jax_skips(arch):
    size = 75 if arch == 'inception_v3' else 32
    params = dict(build_model(arch, device='cpu', input_size=size)[0].state_dict())
    tree = flax_from_state_dict(params, arch)
    from cnn_quantization_tpu.engine.engine import iter_weight_leaves
    j_skipped = {p for p, leaf in iter_weight_leaves(tree)
                 if j_kmeans.is_ignored(p, np.asarray(leaf['kernel']))}
    skipped = {_jax_path(k[:-len('.weight')]) if arch != 'inception_v3'
               else k[:-len('.weight')].replace('.', '/')
               for k in kmeans.weight_names(params) if kmeans.is_ignored(k, params[k])}
    assert skipped == j_skipped and skipped


def test_kmeans_process_params_values():
    params = dict(build_model('resnet18', device='cpu', seed=3)[0].state_dict())
    small = {k: v for k, v in params.items() if k.startswith(('conv1.', 'layer1.0.', 'fc.'))}
    out, inertia = kmeans.process_params(small, 2, 'quantize')
    assert sorted(inertia) == ['layer1.0.conv1.weight', 'layer1.0.conv2.weight']
    for name in inertia:
        assert torch.unique(out[name]).numel() <= 4
    assert torch.equal(out['conv1.weight'], small['conv1.weight'])     # the stem: skipped
    assert torch.equal(out['fc.weight'], small['fc.weight'])           # the classifier
    bc, _ = kmeans.process_params(small, 2, 'quantize', bias_corr=True)
    w, q = small['layer1.0.conv1.weight'], bc['layer1.0.conv1.weight']
    torch.testing.assert_close(q.mean(dim=(1, 2, 3)), w.mean(dim=(1, 2, 3)), rtol=0, atol=1e-6)
    clipped, _ = kmeans.process_params(small, 2, 'clip')
    c = clipped['layer1.0.conv1.weight']
    assert c.min() >= w.min() and c.max() <= w.max() and torch.unique(c).numel() > 4


def test_kmeans_cli_output_reads_in_both_packages(tmp_path, monkeypatch, capsys):
    """The CLI's .npz has the JAX model's tree (names and shapes of its init)
    and loads through the port's ``inference_sim --weights``."""
    import jax
    import jax.numpy as jnp
    from cnn_quantization_tpu.engine import TapContext as JTap
    from cnn_quantization_tpu.models import build_model as j_build_model
    from cnn_quantization_tpu.utils.checkpoint import load_params_npz as j_load
    from cnn_quantization_tpu_torch.cli import inference_sim
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.chdir(tmp_path)
    arch = 'squeezenet1_1'
    assert kmeans.main(['-a', arch, '-bits', '4', '--device', 'cpu',
                        '--out_dir', str(tmp_path)]) == 0
    assert 'inertia' in capsys.readouterr().out
    path = tmp_path / f'{arch}_kmeans4bit.npz'
    assert (tmp_path / f'{arch}_kmeans4bit_bcorr.npz').exists()
    tree = j_load(str(path))
    model, _ = j_build_model(arch)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), JTap()),
                            jax.random.PRNGKey(0))['params']
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, s: a.shape == s.shape, tree, shapes))
    for leaf in ('features_3/expand1x1', 'classifier_1'):
        node = tree
        for seg in leaf.split('/'):
            node = node[seg]
        assert np.unique(node['kernel']).size <= 16
    assert inference_sim.main(['-a', arch, '--device', 'cpu', '-b', '2', '--subset', '2',
                               '--input_size', '64', '--weights', str(path)]) == 0
    assert 'random init' not in capsys.readouterr().out


@pytest.mark.parametrize('arch', available_archs())
def test_flax_from_state_dict_inverts_the_bridge(arch, monkeypatch):
    """``flax_from_state_dict`` is the inverse of ``state_dict_from_flax`` for
    every architecture; for one of each family its tree has the JAX model's
    names and shapes.  The weights are numbered, not initialised (an
    initialisation of the largest archs costs seconds)."""
    from cnn_quantization_tpu_torch.models import zoo
    monkeypatch.setattr(zoo, 'init_parameters', lambda model, seed: model)
    size = 75 if arch == 'inception_v3' else 64
    model, _ = build_model(arch, device='cpu', input_size=size)
    state = dict(model.state_dict())
    with torch.no_grad():
        for i, v in enumerate(state.values()):
            if v.is_floating_point():
                v.copy_(torch.arange(v.numel(), dtype=v.dtype).reshape(v.shape) + i)
    tree = flax_from_state_dict(state, arch)
    back = state_dict_from_flax(tree, arch)
    assert set(back) == {k for k in state if not k.endswith('.num_batches_tracked')}
    for k, v in back.items():
        assert torch.equal(v, state[k]), k
    if arch in ('resnet18', 'resnext50_32x4d', 'vgg16_bn', 'inception_v3', 'mobilenet_v2',
                'densenet121', 'googlenet', 'shufflenet'):
        import jax
        import jax.numpy as jnp
        from cnn_quantization_tpu.engine import TapContext as JTap
        from cnn_quantization_tpu.models import build_model as j_build_model
        j_model, _ = j_build_model(arch)
        shapes = jax.eval_shape(lambda k: j_model.init(k, jnp.zeros((1, size, size, 3)), JTap()),
                                jax.random.PRNGKey(0))['params']
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes)
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, s: a.shape == s.shape, tree, shapes))


def test_golden_verdict_holds_top5():
    assert golden_repro.verdict(73.3, 91.3, 73.33, 91.334, 0.5) == 'PASS'
    assert golden_repro.verdict(73.3, 89.0, 73.33, 91.334, 0.5) == 'FAIL'   # top-1 in band
    assert golden_repro.verdict(70.0, 91.3, 73.33, 91.334, 0.5) == 'FAIL'


def test_golden_smoke_runs_every_config(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / 'rows.json'
    assert golden_repro.main(['--smoke', '--device', 'cpu', '--out', str(out)]) == 0
    import json
    rows = json.loads(out.read_text())
    assert [r['config'] for r in rows] == [name for name, *_ in golden_repro.GOLDEN]
    assert all(np.isfinite([r['top1'], r['top5']]).all() and 'no verdict' not in r['verdict']
               for r in rows)
    assert 'avg_entropy' in rows[-1]


def test_entry_points_default_to_the_card():
    """Without a card the tools' entry points raise unless 'cpu' is asked
    for (on a machine with one they run there)."""
    if torch.cuda.is_available():
        return
    for call in (lambda: mse_analysis.compare('laplace', 4, n=10),
                 lambda: bit_alloc_synthetic.run(n=10),
                 lambda: kmeans.load_state('squeezenet1_1', None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
