"""The port's sweeps and output flags (-ep, -ct, -ms, -dd) on the CPU at
resnet18 64x64 beside the JAX CLI on the same ``.npz`` weights and synthetic
batches: each writes the files the JAX CLI writes, with its rows and
columns.  Values within the bars of tests/_torch_cli_pair.py: accuracies
equal; -ms: the float forward's norms within 1e-5 relative, the quantized
forward's columns within 1e-1 (the quantized forward is as chaotic as the
loss, and more so at the deepest sites: 7.5e-2 at avgpool0_out's mse);
-dd: the activations of the quantized-weight model within 1e-2 of their
largest magnitude (the JAX CLI's jitted weight pass flips weight codes at
rounding ties; measured 5e-4 at linear0_activation)."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from _torch_cli_pair import base_args, cli, j_cli, run, run_both, write_weights

W4A4 = ['--qtype', 'int4', '-qw', 'int4']


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp('weights') / 'resnet18.npz')


@pytest.fixture(autouse=True)
def _no_imagenet(monkeypatch):
    monkeypatch.delenv('IMAGENET_DIR', raising=False)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six test files at once."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _csvs(tmp_path, rel):
    return {k: pd.read_csv(tmp_path / k / rel) for k in ('jax', 'port')}


def test_eval_precision_sweep(weights, tmp_path, monkeypatch):
    """-ep: fp32, then activations at int8..int4, one CSV row each."""
    args = base_args(weights, subset=2) + W4A4 + ['-pcq_w', '-c', 'laplace', '-ep']
    out = run_both(args, tmp_path, monkeypatch)
    assert out['jax'][0] == out['port'][0] == 0
    csv = _csvs(tmp_path, 'results/precision/resnet18_laplace_clipping.csv')
    for df in csv.values():
        assert list(df.columns) == ['dtype', 'val_prec1', 'val_prec5']
        assert list(df['dtype']) == ['fp32', 'int8', 'int7', 'int6', 'int5', 'int4']
    pd.testing.assert_frame_equal(csv['port'], csv['jax'])
    assert sum(ln.startswith('Test: [') for ln in out['port'][1]) == 6


def test_custom_test_sweep_with_order_file(weights, tmp_path, monkeypatch):
    """-ct --order_file: 8-bit layers added one by one (conv0 always), one
    CSV row an evaluation, written as it goes."""
    order = tmp_path / 'order.json'
    order.write_text(json.dumps(['conv5_activation', 'conv9_activation', 'linear0_activation']))
    args = base_args(weights, subset=2) + W4A4 + ['-ct', '--order_file', str(order)]
    out = run_both(args, tmp_path, monkeypatch)
    assert out['jax'][0] == out['port'][0] == 0
    csv = _csvs(tmp_path, 'results/custom_test/resnet18_max_mse_no_cliping_layer_selection.csv')
    for df in csv.values():
        assert list(df.columns) == ['num_8bit_layers', 'indexes', 'val_prec1', 'val_prec5']
        assert list(df['num_8bit_layers']) == [1, 2, 3, 4]
    pd.testing.assert_frame_equal(csv['port'], csv['jax'])
    assert eval(csv['port']['indexes'][3]) == ['conv0_activation', 'conv5_activation',
                                               'conv9_activation', 'linear0_activation']


def test_custom_test_order_from_error_stats(weights, tmp_path, monkeypatch):
    """-ct without --order_file under -sm use: the sites by their collected
    scalar/mean_mse_lowp, largest first, the order the JAX CLI's
    ``_load_order`` derives from the same stats; neither stats nor a file
    exits."""
    import argparse
    rc, _, _ = run(cli.main, base_args(weights, subset=2) + W4A4 + ['-sm', 'collect'],
                   tmp_path, monkeypatch)
    assert rc == 0
    from cnn_quantization_tpu_torch.calib.calibrator import load_stats
    stats = load_stats(str(tmp_path / 'mxt-sim-tpu' / 'statistics' / 'resnet18.npz'))
    args = argparse.Namespace(order_file=None)
    order = cli._load_order(args, stats)
    assert order == j_cli._load_order(args, stats) and len(order) == 23
    errs = [float(stats[s]['scalar/mean_mse_lowp']) for s in order]
    assert errs == sorted(errs, reverse=True)
    for fn in (cli._load_order, j_cli._load_order):
        with pytest.raises(SystemExit, match='custom_test needs --order_file'):
            fn(args, None)


def test_measure_stats(weights, tmp_path, monkeypatch):
    """-ms: per-site float-vs-quantized distances, one CSV under
    ~/mxt-sim-tpu/distance/<arch>."""
    args = base_args(weights, subset=2) + W4A4 + ['-pcq_w', '-pcq_a', '-c', 'laplace', '-ms']
    out = run_both(args, tmp_path, monkeypatch)
    assert out['jax'][0] == out['port'][0] == 0
    rel = 'mxt-sim-tpu/distance/resnet18/resnet18_distance.csv'
    a = pd.read_csv(tmp_path / 'port' / rel, index_col=0)
    b = pd.read_csv(tmp_path / 'jax' / rel, index_col=0)
    assert list(a.columns) == list(b.columns) == ['norm_fp', 'norm_q', 'mse', 'cos', 'rel_err']
    assert list(a.index) == list(b.index) and len(a) == 23
    np.testing.assert_allclose(a['norm_fp'], b['norm_fp'], rtol=1e-5)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-1, atol=1e-6)
    assert out['port'][1][-1].startswith('Saved measurement summary for 23 sites')


def test_dump_dir(weights, tmp_path, monkeypatch):
    """-dd: every site's pre-quantization activation of the first batch as
    <dir>/batch0/<site>.npy (NCHW in the port, NHWC in JAX)."""
    outs = {k: str(tmp_path / f'dump_{k}') for k in ('jax', 'port')}
    res = {}
    for k in outs:
        res[k] = run(j_cli.main if k == 'jax' else cli.main,
                     base_args(weights, subset=2) + W4A4 + ['-pcq_w', '-dd', outs[k]],
                     tmp_path / k, monkeypatch)
        assert res[k][0] == 0
    names = {k: sorted(os.listdir(os.path.join(v, 'batch0'))) for k, v in outs.items()}
    assert names['port'] == names['jax'] and len(names['port']) == 23
    for name in names['port']:
        a = np.load(os.path.join(outs['port'], 'batch0', name))
        b = np.load(os.path.join(outs['jax'], 'batch0', name))
        if a.ndim == 4:
            a = a.transpose(0, 2, 3, 1)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-2 * (np.abs(b).max() + 1e-6), name
    assert res['port'][1][-1] == f"Dumped 23 activations to {outs['port']}"
