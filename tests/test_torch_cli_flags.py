"""Each flag this slice ports into the port's ``inference_sim``, run on the CPU
at resnet18 64x64 beside the JAX CLI on the same ``.npz`` weights and
synthetic batches.  Bars: tests/_torch_cli_pair.py (top-1/top-5 equal, loss
within 5e-2 relative: end-to-end chaos at rounding ties; the numerics of
each flag are held site by site in tests/test_torch_mid_tread.py,
tests/test_torch_kld.py and tests/test_torch_ops.py, its wiring into the
policy field by field against the JAX CLI's ``policy_from_args``)."""

import os

import numpy as np
import pytest
import torch

from cnn_quantization_tpu.utils.checkpoint import load_params_npz as j_load_params_npz

from cnn_quantization_tpu_torch.cli.inference_sim import main
from cnn_quantization_tpu_torch.utils.checkpoint import load_params_npz
from cnn_quantization_tpu_torch.utils.flax_params import state_dict_from_flax
from _torch_cli_pair import (assert_results_close, base_args, run, run_both, stats_file,
                             write_weights)

W4A4 = ['--qtype', 'int4', '-qw', 'int4']
HEADLINE = W4A4 + ['-pcq_w', '-pcq_a', '-c', 'laplace', '-baa', '-baw', '-bcw']


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp('weights') / 'resnet18.npz')


@pytest.fixture(autouse=True)
def _no_imagenet(monkeypatch):
    monkeypatch.delenv('IMAGENET_DIR', raising=False)


FLAGS = {
    'dtype_bf16': ['--dtype', 'bfloat16', '--qtype', 'int8'],
    'q_off': HEADLINE + ['--q_off'],
    # the fp32 clippers, the bit-allocation knobs and variance correction
    'policy_knobs': W4A4 + ['-pcq_w', '-pcq_a', '-c', 'laplace', '-baa', '-baw', '-bcw', '-vcw',
                            '-ra', '3', '-rw', '0.8', '-bam', 'ceil', '-bap', 'laplace',
                            '-bata', '4.5', '-batw', '4.2'],
    'mid_tread': W4A4 + ['-pcq_w', '-pcq_a', '-mtq', '-c', 'laplace', '-baa', '-baw', '-me'],
    'mid_tread_per_tensor': W4A4 + ['-pcq_w', '-mtq', '-c', 'laplace', '-me'],
    'stochastic': ['--qtype', 'int8', '-qw', 'int8', '-s'],
    # the 2std clipper per tensor (no -pcq_*), the ordering task's fifth config
    'two_std': ['--qtype', 'int4', '-qw', 'int8', '-c', '2std'],
}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_policy_from_args_passes_every_field():
    """Every policy field the JAX CLI sets from its flags, the port sets from
    the same flags (JAX cli/inference_sim.py:123-138)."""
    import dataclasses
    from cnn_quantization_tpu.cli import inference_sim as j_cli
    from cnn_quantization_tpu_torch.cli import inference_sim as cli
    argv = ['-a', 'resnet50', '--qtype', 'int4', '-qw', 'int3', '-c', 'laplace', '-sk', 'max',
            '-kld', '-pcq_w', '-pcq_a', '-baa', '-baw', '-bam', 'ceil', '-bap', 'laplace',
            '-bata', '4.5', '-batw', '3.5', '-bca', '-bcw', '-vcw', '-me', '-mtq', '-s',
            '-ra', '2.5', '-rw', '0.9']
    want = dataclasses.asdict(j_cli.policy_from_args(j_cli.build_parser().parse_args(argv)))
    got = dataclasses.asdict(cli.policy_from_args(cli.build_parser().parse_args(argv)))
    assert got == want
    assert sum(v not in (None, False) for v in got.values()) == len(got)
    # the JAX CLI's defaults, flag by flag, where the port parses the flag too
    j_defaults = vars(j_cli.build_parser().parse_args([]))
    defaults = vars(cli.build_parser().parse_args([]))
    differ = {k for k in j_defaults if defaults.get(k, 'missing') != j_defaults[k]}
    # only the device: the card for the port ('tpu' for JAX); --data, -j and
    # the mesh flags take the JAX CLI's defaults since they run
    assert differ == {'device'}


@pytest.mark.parametrize('name', list(FLAGS))
def test_flag_matches_jax_cli(name, weights, tmp_path, monkeypatch):
    out = run_both(base_args(weights) + FLAGS[name], tmp_path, monkeypatch)
    assert_results_close(out)
    if name == 'q_off':
        assert out['port'][2]['loss'] == pytest.approx(out['jax'][2]['loss'], rel=1e-5)
    if '-me' in FLAGS[name]:
        assert 0.0 < out['port'][2]['avg_entropy'] <= 4.0
        assert any(ln.startswith('Average bit rate: avg.entropy.act') for ln in out['port'][1])


def test_weights_npz_load_the_jax_tree(weights, tmp_path, monkeypatch):
    """``--weights *.npz``: the JAX package's tree, converted to the port's
    names and layouts; the model computes on exactly those tensors."""
    from cnn_quantization_tpu_torch.cli import inference_sim as cli
    want = state_dict_from_flax(j_load_params_npz(weights))
    assert sorted(load_params_npz(weights)) == sorted(j_load_params_npz(weights))
    seen = {}
    real = cli.load_params

    def spy(args, model, meta):
        seen.update(real(args, model, meta))
        return dict(seen)

    monkeypatch.setattr(cli, 'load_params', spy)
    rc, lines, _ = run(main, base_args(weights) + ['--qtype', 'int8'], tmp_path, monkeypatch)
    assert rc == 0 and not any('random init' in ln for ln in lines)
    assert sorted(seen) == sorted(want)
    for k, v in want.items():
        assert torch.equal(seen[k], v), k


def test_print_freq(weights, tmp_path, monkeypatch):
    """``-p 1`` prints a progress line a batch (the JAX CLI's
    ``i % print_freq == 0``); the default prints the first batch's only."""
    for p, lines in (('1', 2), ('10', 1)):
        rc, out, _ = run(main, base_args(weights) + ['--qtype', 'int8', '-p', p],
                         tmp_path / p, monkeypatch)
        assert rc == 0 and sum(ln.startswith('Test: [') for ln in out) == lines


def test_stochastic_rounding_is_seeded(weights, tmp_path, monkeypatch):
    """``-s``: the same --seed gives the same result; the noise moves it."""
    args = base_args(weights) + ['--qtype', 'int8', '-qw', 'int8']
    res = [run(main, args + extra, tmp_path / str(i), monkeypatch)[2]
           for i, extra in enumerate((['-s'], ['-s'], []))]
    res = [{k: v for k, v in r.items() if k != 'images_per_sec'} for r in res]
    assert res[0] == res[1] and res[0]['loss'] != res[2]['loss']


def test_mlf_experiment_names_the_run(weights, tmp_path, monkeypatch):
    """``-mlexp``: the tracker's runs go under that experiment, with the
    params and metrics the JAX CLI's tracker writes."""
    out = run_both(base_args(weights) + ['--qtype', 'int8', '-mlexp', 'exp1'], tmp_path,
                   monkeypatch)
    assert_results_close(out)
    runs = {}
    for pkg in ('jax', 'port'):
        root = tmp_path / pkg / 'mlruns_mxt_tpu' / 'exp1'
        (run_dir,) = os.listdir(root)
        assert run_dir.startswith('resnet18_Wint8Aint8_')
        keys = [ln.split('"key": "')[1].split('"')[0]
                for ln in (root / run_dir / 'metrics.jsonl').read_text().splitlines()]
        runs[pkg] = (keys, sorted((root / run_dir / 'params.json').read_text().splitlines()))
    assert runs['port'][0] == runs['jax'][0] == ['top1', 'top5', 'loss']
    # the port's parser has the JAX parser's flags and defaults, but --device
    # (the card, not 'tpu'), --data and the unported -j and --mesh_model
    diff = set(runs['port'][1]) ^ set(runs['jax'][1])
    assert {ln.split('"')[1] for ln in diff} <= {'device', 'data', 'workers', 'mesh_model'}


# ---------------------------------------------------------------- stats flows

def _assert_stats_close(a_path, b_path, kld_bins=None):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if kld_bins is not None and k.endswith('_kld_th'):
                assert abs(float(a[k]) - float(b[k])) <= kld_bins(k), k
            else:
                # kurtosis: a fourth power of (x - mean) / std (tests/test_torch_engine.py)
                atol = 1e-4 if k.endswith('kurtosis') else 1e-5
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=atol, err_msg=k)


def test_stats_folder_batch_avg_kind_and_bias_corr(weights, tmp_path, monkeypatch):
    """``-sf`` names the artifact, ``-sba`` batch-averages min/max at collect;
    ``-sk max`` and ``-bca`` apply at use."""
    common = base_args(weights) + HEADLINE + ['-sf', 'other']
    out = run_both(common + ['-sm', 'collect', '-sba'], tmp_path, monkeypatch)
    assert out['jax'][0] == out['port'][0] == 0
    paths = {k: stats_file(tmp_path / k, 'other', per_channel=True) for k in out}
    _assert_stats_close(paths['port'], paths['jax'])
    plain = run(main, common + ['-sm', 'collect'], tmp_path / 'no_sba', monkeypatch)
    with np.load(paths['port']) as a, \
            np.load(stats_file(tmp_path / 'no_sba', 'other', per_channel=True)) as b:
        assert not np.array_equal(a['conv1_activation|scalar/mean_max'],
                                  b['conv1_activation|scalar/mean_max'])
    assert plain[0] == 0
    out = run_both(common + ['-sm', 'use', '-sk', 'max', '-bca'], tmp_path, monkeypatch)
    assert_results_close(out)
    assert 'Froze qparams for 23 sites' in out['port'][1]


def test_kld_collect_then_use(weights, tmp_path, monkeypatch):
    """``-kld``: the collect run adds scalar/*_kld_th at every site of
    ``<arch>_kld_<qtype>.npz``, within two bins of the JAX CLI's; the use run
    freezes every site and agrees with the JAX CLI, as does one with ``-me``,
    whose activation sites stay dynamic."""
    out = run_both(base_args(weights) + W4A4 + ['-sm', 'collect', '-kld', '-cs', '4'],
                   tmp_path, monkeypatch)
    assert out['jax'][0] == out['port'][0] == 0
    paths = {k: stats_file(tmp_path / k, 'resnet18_kld_int4') for k in out}
    with np.load(paths['jax']) as j:
        absmax = {k.split('|')[0]: max(abs(float(j[k])),
                                       abs(float(j[k.replace('max_max', 'min_min')])))
                  for k in j.files if k.endswith('|scalar/max_max')}
        sites = {k.split('|')[0] for k in j.files}
    assert all(f'{s}|scalar/{kind}_kld_th' in np.load(paths['port']).files
               for s in sites for kind in ('min', 'mean', 'max')) and len(sites) == 23
    _assert_stats_close(paths['port'], paths['jax'],
                        kld_bins=lambda k: 2 * 2 * absmax[k.split('|')[0]] / 2001 + 1e-6)
    use = base_args(weights) + W4A4 + ['-pcq_w', '-sm', 'use', '-kld']
    out = run_both(use, tmp_path, monkeypatch)
    assert_results_close(out)
    assert 'Froze qparams for 23 sites' in out['port'][1]
    # the JAX CLI evaluates every site dynamically either way, so its run above
    # is what the port's -me run (activation sites dynamic) is held to
    out['port'] = run(main, use + ['-me'], tmp_path / 'port', monkeypatch)
    assert_results_close(out)
