"""The recipes' accuracy ordering on a trained ResNet-18, through the port on
the CPU: the JAX package's ``tests/test_accuracy_ordering.py`` with the
port's trainer and CLI (``chip_smoke.train_ordering_net``, the six golden
configurations, the six assertions), and the JAX-trained weights of that
test through both packages' CLIs, config by config, at the CLI-pair bar
(``tests/_torch_cli_pair.py``: top-1/top-5 equal, loss within
``LOSS_RTOL``), against the JAX CLI as it runs (jitted) and under
``jax.disable_jit()``; and, site by site, the eager JAX forward's own
quantized-path inputs through the port's quantizers.  The card runs the same
ordering in ``chip_smoke.py``'s ``accuracy_path`` phase.

The 4-bit configs' CLI pairs need not hold their bar: each CLI run is one
draw of the recipe's float-order chaos, and the bar asks one draw to equal
another.  What holds the two packages together on these configs is their
band (``tests/test_torch_accuracy_band_slow.py``): the port's band mean
within 3 combined standard errors of the JAX package's, jitted and eager.

Runtime: 11-16 min on an 8-core CPU, most of it the two trainings (the
JAX fixture is the JAX test's own).  Gated behind ``CNNQ_RUN_SLOW=1`` as the
JAX test is:

    CNNQ_RUN_SLOW=1 JAX_PLATFORMS=cpu python -m pytest \\
        tests/test_torch_accuracy_ordering_slow.py -q -s
"""

import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from cnn_quantization_tpu.cli import inference_sim as j_cli
from cnn_quantization_tpu_torch.cli.inference_sim import main
from cnn_quantization_tpu_torch.utils.checkpoint import save_params_npz
from cnn_quantization_tpu_torch.utils.flax_params import flax_from_state_dict
from _torch_cli_pair import assert_results_close, run, run_both
from test_accuracy_ordering import trained_assets  # noqa: F401  (a fixture)

pytestmark = pytest.mark.skipif(
    not os.environ.get('CNNQ_RUN_SLOW'),
    reason='trains a ResNet-18 for ~10-15 min; set CNNQ_RUN_SLOW=1 to run')


@pytest.fixture(autouse=True)
def _no_imagenet(monkeypatch):
    monkeypatch.delenv('IMAGENET_DIR', raising=False)


@pytest.fixture(scope='module')
def port_assets(tmp_path_factory):
    """The port's trainer on the CPU, its weights as the JAX package's .npz."""
    out = tmp_path_factory.mktemp('port_ordering')
    model, _, (xte, yte), train = chip_smoke.train_ordering_net(torch.device('cpu'))
    print(f"\nport training on the CPU: {train}")
    wpath, dpath = str(out / 'resnet18_syn.npz'), str(out / 'eval.npz')
    save_params_npz(wpath, flax_from_state_dict(model.state_dict(), 'resnet18'))
    np.savez(dpath, images=xte, labels=yte)
    return wpath, dpath


def _base(wpath, dpath):
    return ['--device', 'cpu', '-a', 'resnet18', '-b', '256', '--data', dpath,
            '--weights', wpath]


def test_port_recipe_accuracy_ordering(port_assets, tmp_path, monkeypatch):
    top1 = {}
    for name, flags in chip_smoke.ORDERING_CONFIGS.items():
        rc, _, res = run(main, _base(*port_assets) + flags, tmp_path / name, monkeypatch)
        assert rc == 0 and res is not None, name
        top1[name] = res['top1']
    print(f'\nport-trained, port CLI top-1: {top1}')
    held = chip_smoke.ordering_holds(top1)
    assert all(held.values()), (held, top1)


@pytest.mark.parametrize('name', list(chip_smoke.ORDERING_CONFIGS))
def test_jax_trained_weights_through_both_clis(name, trained_assets, tmp_path,  # noqa: F811
                                               monkeypatch):
    out = run_both(_base(*trained_assets) + chip_smoke.ORDERING_CONFIGS[name], tmp_path,
                   monkeypatch)
    print(f"\nJAX-trained, {name}: JAX CLI {out['jax'][2]}, port CLI {out['port'][2]}")
    assert_results_close(out)


@pytest.mark.parametrize('name', list(chip_smoke.ORDERING_CONFIGS))
def test_jax_trained_weights_port_cli_against_eager_jax_cli(name, trained_assets,  # noqa: F811
                                                            tmp_path, monkeypatch):
    """As above with the JAX CLI under ``jax.disable_jit()``, whose weight
    pass the port's equals bit for bit for the three 4-bit configs
    (``tests/test_torch_accuracy_band_slow.py``; XLA's jitted pass
    divides by qmax through its reciprocal and multiplies by 1/n in the
    bias correction's means, which moves codes at rounding ties).  The
    4-bit configs still differ here by a draw of their float order: their
    activation statistics sum in another order than XLA's
    (``tests/test_torch_accuracy_band_slow.py``, steps c-d; summed in XLA's
    order, a test-only stand-in, the port's headline scores 74.0234 against
    this CLI's 73.9746), and both packages' bands agree within their bar."""
    argv = _base(*trained_assets) + chip_smoke.ORDERING_CONFIGS[name]
    with jax.disable_jit():
        eager = run(j_cli.main, argv, tmp_path / 'jax', monkeypatch)
    out = {'jax': eager, 'port': run(main, argv, tmp_path / 'port', monkeypatch)}
    print(f"\nJAX-trained, {name}: eager JAX CLI {out['jax'][2]}, port CLI {out['port'][2]}")
    assert_results_close(out)


@pytest.mark.parametrize('name', ['naive_w4a4', 'headline', '2std'])
def test_jax_trained_weights_quantized_path_sites(name, trained_assets,  # noqa: F811
                                                  monkeypatch):
    """Every site of the eager JAX forward of 256 test images under a 4-bit
    config, its own pre-quantization input (the quantized path's, not the
    float model's) handed to the port's quantizer: the outputs agree but for
    codes flipped at rounding ties, at most 1 in 100,000 elements a site (an
    element further from JAX's than 1e-4 of the site's largest value counts
    as flipped).  The flips come from the per-channel statistics (the
    Laplace ``b`` sums over N*H*W in torch's order, XLA's in windows of 32),
    which put a site's clip values a few ulps apart; free running, the first
    site flips 2 codes and the flips compound through the trunk
    (``tests/test_torch_accuracy_band_slow.py``).  The end-to-end gaps of
    the two tests above are one draw of that spread: the port's band agrees
    with the JAX package's, jitted and eager, within its bar."""
    import dataclasses
    from cnn_quantization_tpu.engine import QuantEngine as JEngine
    from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
    from cnn_quantization_tpu.engine import context as j_context
    from cnn_quantization_tpu.models import build_model as j_build_model
    from cnn_quantization_tpu.utils.checkpoint import load_params_npz
    from cnn_quantization_tpu_torch.cli import inference_sim as cli
    from cnn_quantization_tpu_torch.engine.context import QuantizeContext
    from cnn_quantization_tpu_torch.engine.qparams import discover_sites
    from cnn_quantization_tpu_torch.models import build_model
    wpath, dpath = trained_assets
    policy = cli.policy_from_args(cli.build_parser().parse_args(
        ['-a', 'resnet18'] + chip_smoke.ORDERING_CONFIGS[name]))
    seen = {}
    real_tap = j_context.QuantizeContext.tap

    def tap(self, x, site):
        out = real_tap(self, x, site)
        seen[site.id] = (np.array(x), np.asarray(out))
        return out

    monkeypatch.setattr(j_context.QuantizeContext, 'tap', tap)
    j_model, j_meta = j_build_model('resnet18')
    j_eng = JEngine(j_model, JPolicy(**dataclasses.asdict(policy)), j_meta)
    with np.load(dpath) as z:
        images = z['images'][:256]
    with jax.disable_jit():
        j_eng.make_forward()(j_eng.quantize_params(load_params_npz(wpath)), None,
                             jax.numpy.asarray(images))
    model, _ = build_model('resnet18', device='cpu')
    sites = {s.id: s for s, _ in discover_sites(model, (1, 3, 32, 32))}
    assert sorted(seen) == sorted(sites) and len(sites) == 23
    ctx = QuantizeContext(policy)
    flips = {}
    for sid, (x, want) in seen.items():
        t = torch.from_numpy(x)
        got = ctx.tap(t.permute(0, 3, 1, 2) if t.ndim == 4 else t, sites[sid])
        got = (got.permute(0, 2, 3, 1) if got.ndim == 4 else got).numpy()
        off = np.abs(got - want) > 1e-4 * np.abs(want).max()
        flips[sid] = int(off.sum())
        assert off.mean() <= 1e-5, (sid, flips[sid], want.size)
    print(f'\n{name}: codes flipped at ties, by site: {flips}')
