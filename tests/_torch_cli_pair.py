"""Shared set-up of the CLI parity tests: both packages' ``inference_sim``
in-process on the CPU, on the same ``.npz`` weights (written by the JAX
package's ``save_params_npz``) and the same synthetic batches, each with a
HOME and a working directory of its own (the stats artifacts, the sweeps'
CSV, the trackers' runs).

The end-to-end bar.  Per site, with the same pre-quantization tensor, the
two quantizers agree to 1e-6 (tests/test_torch_resnet.py, teacher forced),
and the port's weight pass equals the JAX package's eager ops bit for bit
(tests/test_torch_weight_pass_trained_like.py; the bias and variance
correction's per-channel moments sum in XLA's CPU order).  End to end
against the JAX CLI they do not agree that closely: the JAX CLI runs under
``jit``, whose weight pass flips codes at rounding ties (XLA divides by the
constant qmax through its reciprocal and multiplies by 1/n in the
corrections' means: with -vcw, fc.weight 7.8e-3 apart from JAX's own eager
ops); the activation statistics sum in another order than XLA's, which
puts a per-channel clip value a few ulps apart, and a last-bit difference
of a float conv puts an activation on the other side of a tie; a flipped
code compounds through the quantized trunk.  On a trained network at 4 bits
that chaos moves top-1 by a few tenths of a point, so there the packages are
held by their float-order band, not by one run each
(tests/test_torch_accuracy_band_slow.py).  Measured on the CLI's synthetic batches at resnet18 64x64
(run this file, see its end): the parent's own int8 flags 1.8e-3 apart in
loss, the W4A4 headline recipe 2.8e-3, -vcw 2.3e-2 (ROADMAP Queue 3).  So
the CLI tests hold top-1 and top-5 equal and the loss within ``LOSS_RTOL`` =
5e-2 relative; each flag's numerics are held site by site in the module
tests, and its wiring by ``test_policy_from_args_passes_every_field``.
"""

import contextlib
import io
import json
import os

import numpy as np

from cnn_quantization_tpu.cli import inference_sim as j_cli
from cnn_quantization_tpu.utils.checkpoint import save_params_npz
from cnn_quantization_tpu.utils.torch_import import import_arch

from cnn_quantization_tpu_torch.cli import inference_sim as cli
from _torch_parity import torchvision_like_state

LOSS_RTOL = 5e-2
# the average code entropy over the same chaotic activations (headline -me:
# 1.6e-3 bits apart of 2.58)
ENTROPY_ATOL = 1e-2


def write_weights(path, arch='resnet18'):
    """BN-folded torchvision-like weights as the JAX package's .npz tree."""
    save_params_npz(str(path), import_arch(arch, torchvision_like_state(arch), fold_bn=True))
    return str(path)


def base_args(weights, arch='resnet18', batch=2, subset=4, size=64):
    return ['-a', arch, '-b', str(batch), '--subset', str(subset), '--input_size', str(size),
            '--data', '/nonexistent', '--device', 'cpu', '--weights', weights]


@contextlib.contextmanager
def _home(path, monkeypatch):
    path.mkdir(parents=True, exist_ok=True)
    with monkeypatch.context() as m:
        m.setenv('HOME', str(path))
        m.chdir(path)
        yield path


def run(main, argv, home, monkeypatch):
    """rc, stdout lines and the last line's JSON (or None) of one CLI call."""
    buf = io.StringIO()
    with _home(home, monkeypatch), contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        res = None
    return rc, lines, res


def run_both(argv, tmp_path, monkeypatch):
    """{'jax': (rc, lines, res), 'port': ...}; HOME/cwd tmp_path/<package>."""
    return {'jax': run(j_cli.main, argv, tmp_path / 'jax', monkeypatch),
            'port': run(cli.main, argv, tmp_path / 'port', monkeypatch)}


def assert_results_close(out):
    """Both calls exited 0 with results: top-1/top-5 equal, the loss within
    LOSS_RTOL, an entropy rate within ENTROPY_ATOL bits."""
    (j_rc, _, want), (rc, _, got) = out['jax'], out['port']
    assert j_rc == rc == 0 and want is not None and got is not None
    assert sorted(got) == sorted(want)
    assert got['top1'] == want['top1'] and got['top5'] == want['top5']
    assert np.isfinite(got['loss'])
    assert abs(got['loss'] - want['loss']) <= LOSS_RTOL * abs(want['loss']), (got, want)
    if 'avg_entropy' in want:
        assert abs(got['avg_entropy'] - want['avg_entropy']) <= ENTROPY_ATOL, (got, want)


def stats_file(home, name, per_channel=False):
    sub = 'statistics/per_channel' if per_channel else 'statistics'
    return os.path.join(str(home), 'mxt-sim-tpu', sub, f'{name}.npz')


def _report(argv_sets, workdir):
    """Print, for each flag set, both CLIs' losses and their relative gap; and
    the jitted JAX weight pass's largest gap from its own eager ops."""
    import pathlib
    import jax
    from cnn_quantization_tpu.engine import QuantEngine as JEngine
    from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
    from cnn_quantization_tpu.models import build_model as j_build_model
    from cnn_quantization_tpu.utils.checkpoint import load_params_npz

    class _Patch:   # a stand-in for pytest's monkeypatch.context()
        def context(self):
            import pytest
            return pytest.MonkeyPatch.context()

    work = pathlib.Path(workdir)
    weights = write_weights(work / 'resnet18.npz')
    for extra in argv_sets:
        out = run_both(base_args(weights) + extra, work / '_'.join(extra), _Patch())
        want, got = out['jax'][2]['loss'], out['port'][2]['loss']
        print(f"{' '.join(extra)}: loss JAX {want} port {got} "
              f'relative gap {abs(got - want) / abs(want):.3g}')
        if 'avg_entropy' in out['jax'][2]:
            print(f"  avg_entropy JAX {out['jax'][2]['avg_entropy']} "
                  f"port {out['port'][2]['avg_entropy']}")
    model, meta = j_build_model('resnet18')
    params = load_params_npz(weights)
    eng = JEngine(model, JPolicy(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                                 clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                                 bias_corr_weight=True, var_corr_weight=True, arch='resnet18'),
                  meta)
    jitted = jax.device_get(eng.quantize_params(params))
    with jax.disable_jit():
        eager = jax.device_get(eng.quantize_params(params))
    gaps = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12)), jitted, eager)
    leaves = jax.tree_util.tree_flatten_with_path(gaps)[0]
    path, gap = max(leaves, key=lambda kv: kv[1])
    print(f'headline -vcw weight pass, jitted vs eager JAX: largest relative gap {gap:.3g} '
          f'at {jax.tree_util.keystr(path)}')


if __name__ == '__main__':
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/_torch_cli_pair.py <scratch dir>
    import sys
    W4A4 = ['--qtype', 'int4', '-qw', 'int4']
    HEADLINE = W4A4 + ['-pcq_w', '-pcq_a', '-c', 'laplace', '-baa', '-baw', '-bcw']
    _report([['--qtype', 'int8', '-qw', 'int8'], HEADLINE, HEADLINE + ['-vcw'],
             HEADLINE + ['-me']], sys.argv[1])
