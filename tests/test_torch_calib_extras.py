"""The port's calibration extras and utilities against the JAX package's
modules on the same seeded inputs: capture, measure, angle stats, monitor,
dump manager, misc, eval log, tracker and results log.

Tolerances:
  * activations (capture, monitor, dumps): within 1e-4 of the tensor's
    largest magnitude (float32 convs summed in another order);
  * -ms distances on the headline recipe: 1e-4 relative, on inputs where the
    two quantized forwards put no value on a rounding tie (the inputs of
    tests/test_torch_resnet.py; on others a code flipped at a tie compounds
    through the 4-bit trunk);
  * angles: 1e-5 rad (a float32 Gram product in another order; the
    activations are random, so no angle is near 0 where arccos is steep);
  * files written by the standard library against pandas': equal bytes for
    the sweeps' CSV, equal parsed values for JSON (pandas rounds to 10
    digits).
Activations are NCHW in the port, NHWC in the JAX package.
"""

import argparse
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cnn_quantization_tpu.calib import angle_stats as j_angle
from cnn_quantization_tpu.calib import measure as j_measure
from cnn_quantization_tpu.calib.capture import make_capture_fn as j_make_capture_fn
from cnn_quantization_tpu.data.synthetic import synthetic_batches
from cnn_quantization_tpu.utils import dump_manager as j_dump
from cnn_quantization_tpu.utils import misc as j_misc
from cnn_quantization_tpu.utils import monitor as j_monitor
from cnn_quantization_tpu.utils.eval_log import EvalLog as JEvalLog
from cnn_quantization_tpu.utils.results_log import ResultsLog as JResultsLog
from cnn_quantization_tpu.utils.tracker import MetricsTracker as JMetricsTracker

from cnn_quantization_tpu_torch.calib import angle_stats, measure
from cnn_quantization_tpu_torch.calib.capture import CaptureContext, make_capture_fn
from cnn_quantization_tpu_torch.utils import dump_manager, misc, monitor
from cnn_quantization_tpu_torch.utils.eval_log import EvalLog
from cnn_quantization_tpu_torch.utils.results_log import ResultsLog
from cnn_quantization_tpu_torch.utils.tracker import MetricsTracker
from _torch_parity import POLICIES, JEngine, JPolicy, Pair, QuantEngine, QuantPolicy


def nhwc(t):
    t = torch.as_tensor(t)
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def assert_acts_close(got, want, what=''):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= 1e-4 * (np.abs(want).max() + 1e-6), what


@pytest.fixture(scope='module')
def r18():
    return Pair('resnet18', 64)


@pytest.fixture(scope='module')
def engines(r18):
    j_eng = JEngine(r18.j_model, JPolicy(arch='resnet18', **POLICIES['headline']), r18.j_meta)
    eng = QuantEngine(r18.model, QuantPolicy(arch='resnet18', **POLICIES['headline']), r18.meta)
    return j_eng, eng


@pytest.fixture(scope='module')
def images():
    return next(synthetic_batches(2, 1, size=64, seed=7))[0]


# ---------------------------------------------------------------- calib

def test_capture_matches_jax(r18, engines, images):
    j_eng, eng = engines
    want = jax.device_get(j_make_capture_fn(j_eng)(r18.j_params, jnp.asarray(images)))
    got = make_capture_fn(eng)(r18.params, images)
    assert sorted(got) == sorted(want) and len(got) == 23
    for site, t in got.items():
        assert_acts_close(nhwc(t), want[site], site)
    ctx = CaptureContext()
    assert ctx.mode == 'capture' and ctx.finalize() == {}


def test_measure_statistics_matches_jax(r18, engines, tmp_path):
    """Float against headline-quantized forwards, per site and batch; then the
    CSV of per-site means in the JAX package's layout."""
    j_eng, eng = engines
    rng = np.random.RandomState(3)
    batches = [((rng.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32), np.zeros(2, np.int32))
               for _ in range(2)]
    want = j_measure.measure_statistics(j_eng, r18.j_params, j_eng.quantize_params(r18.j_params),
                                        batches)
    got = measure.measure_statistics(eng, r18.params, eng.quantize_params(r18.params), batches)
    assert sorted(got) == sorted(want) and len(got) == 23
    for site, rows in got.items():
        assert len(rows) == 2
        for c in measure.COLUMNS:
            np.testing.assert_allclose([r[c] for r in rows], want[site][c].values,
                                       rtol=1e-4, atol=1e-7, err_msg=f'{site} {c}')
    j_path = j_measure.save_measure_csv(want, str(tmp_path / 'jax'), 'resnet18')
    path = measure.save_measure_csv(got, str(tmp_path / 'port'), 'resnet18')
    assert os.path.basename(path) == os.path.basename(j_path) == 'resnet18_distance.csv'
    a, b = pd.read_csv(path, index_col=0), pd.read_csv(j_path, index_col=0)
    assert list(a.index) == list(b.index) and list(a.columns) == list(b.columns)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-4, atol=1e-7)


def test_angle_stats_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    batches = [{'conv0_activation': rng.randn(4, 6, 6, 3).astype(np.float32),
                'linear0_activation': rng.randn(4, 10).astype(np.float32)} for _ in range(2)]
    j_st, st = j_angle.AngleStats(str(tmp_path / 'jax')), angle_stats.AngleStats(str(tmp_path))
    for i, b in enumerate(batches):
        j_st.update(b, targets=np.arange(4) + 4 * i)
        st.update({k: torch.from_numpy(v).permute(0, 3, 1, 2) if v.ndim == 4
                   else torch.from_numpy(v) for k, v in b.items()}, targets=np.arange(4) + 4 * i)
    want = j_angle.load_angle_stats(j_st.save())
    got = angle_stats.load_angle_stats(st.save())
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got['target'], want['target'])
    for site in batches[0]:
        assert got[site].shape == (8, 4)
        np.testing.assert_allclose(got[site], want[site].values, atol=1e-5)
        assert np.all(np.tril(got[site][:4]) == 0.0)
    m = angle_stats.angle_matrix(torch.eye(3))
    np.testing.assert_allclose(m.numpy(), np.triu(np.full((3, 3), np.pi / 2), 1), atol=1e-6)


# ---------------------------------------------------------------- utils

def test_monitor_matches_jax(r18, engines, images, tmp_path):
    j_eng, eng = engines
    want = j_monitor.monitor_forward(j_eng, r18.j_params, jnp.asarray(images))
    got = monitor.monitor_forward(eng, r18.params, images)
    assert sorted(got) == sorted(want) and len(got) == 23
    for site in got:
        assert_acts_close(nhwc(got[site]), want[site], site)
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    attrs = dict(in_channels=4, out_channels=3, kernel_size=(1, 1), weight=w)
    paths = []
    for m, kind in ((j_monitor.Monitor(str(tmp_path / 'jax')), 'jax'),
                    (monitor.Monitor(str(tmp_path / 'port')), 'port')):
        m.register_tensors({'a': w, 'b': w * 2} if kind == 'jax'
                           else {'a': torch.from_numpy(w), 'b': torch.from_numpy(w * 2)})
        m.register_operation('conv1', attrs if kind == 'jax'
                             else {**attrs, 'weight': torch.from_numpy(w)})
        paths.append((m.dump_tensors(1, 2), m.dump_operations(1, 2)))
        assert m.observed_tensors == {} and m.observed_operations == {}
    for j_path, path in zip(*paths):
        assert os.path.basename(j_path) == os.path.basename(path)
        with np.load(j_path) as a, np.load(path) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    assert monitor.MonitorContext().mode == 'monitor'


def test_dump_activations_match_jax(r18, engines, images, tmp_path):
    j_eng, eng = engines
    want = j_dump.dump_activations(j_eng, r18.j_params, jnp.asarray(images), str(tmp_path / 'jax'))
    got = dump_manager.dump_activations(eng, r18.params, images, str(tmp_path / 'port'))
    assert got == want and len(got) == 23
    for site in got:
        a = np.load(tmp_path / 'port' / 'batch0' / f'{site}.npy')
        b = np.load(tmp_path / 'jax' / 'batch0' / f'{site}.npy')
        assert_acts_close(nhwc(a), b, site)   # NCHW in the port, NHWC in JAX
    dm = dump_manager.DumpManager(str(tmp_path / 'plain'))
    dm.dump(torch.ones(2), 'x')
    dm.set_tag('t1')
    dm.dump_all({'y': np.zeros(3)})
    assert (tmp_path / 'plain' / 'x.npy').exists()
    assert (tmp_path / 'plain' / 't1' / 'y.npy').exists()


def test_misc_matches_jax():
    rng = np.random.RandomState(5)
    x, y = rng.randn(4, 6).astype(np.float32), rng.randn(4, 6).astype(np.float32)
    for dims in ((-1,), (0, 1)):
        np.testing.assert_allclose(misc.cos_sim(torch.from_numpy(x), torch.from_numpy(y), dims),
                                   np.asarray(j_misc.cos_sim(x, y, dims)), rtol=1e-6)
    idx = np.array([[0, 3], [2, 1]])
    for kw in ({}, {'N': 5}, {'N': 5, 'ignore_index': 2}):
        got = misc.onehot(torch.from_numpy(idx), **kw)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_misc.onehot(idx, **kw)))
    ids = ['conv10_activation', 'conv2_activation', 'conv1_activation', 'linear0']
    assert misc.sorted_nicely(ids) == j_misc.sorted_nicely(ids) == \
        ['conv1_activation', 'conv2_activation', 'conv10_activation', 'linear0']
    assert set(misc.TORCH_DTYPES) == set(j_misc.JNP_DTYPES)
    draws = []
    for seed_fn in (j_misc.set_global_seeds, misc.set_global_seeds):
        seed_fn(17)
        draws.append((np.random.rand(3), random.random(), torch.rand(3)))
    np.testing.assert_array_equal(draws[0][0], draws[1][0])
    assert draws[0][1] == draws[1][1] and torch.equal(draws[0][2], draws[1][2])
    gen = misc.set_global_seeds(17)
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(17)))


def test_eval_log_writes_the_jax_csv(tmp_path):
    """The precision and sensitivity sweeps' CSV, byte for byte."""
    rows = [(1, str(['conv0_activation']), 0.0, 50.0),
            (2, str(['conv0_activation', 'conv3_activation']), 12.5, 100.0)]
    cols = ['num_8bit_layers', 'indexes', 'val_prec1', 'val_prec5']
    j_log = JEvalLog(cols, str(tmp_path / 'jax' / 'a.csv'), auto_save=True)
    log = EvalLog(cols, str(tmp_path / 'port' / 'a.csv'), auto_save=True)
    for r in rows:
        j_log.log(*r)
        log.log(*r)
        assert (tmp_path / 'port' / 'a.csv').read_bytes() == \
            (tmp_path / 'jax' / 'a.csv').read_bytes()
    prec = [('fp32', 0.0, 0.0), ('int8', 50.0, 75.25)]
    cols = ['dtype', 'val_prec1', 'val_prec5']
    j_log, log = JEvalLog(cols), EvalLog(cols)
    for r in prec:
        j_log.log(*r)
        log.log(*r)
    j_log.save(str(tmp_path / 'jax' / 'p.csv'))
    log.save(str(tmp_path / 'port' / 'p.csv'))
    assert (tmp_path / 'port' / 'p.csv').read_bytes() == (tmp_path / 'jax' / 'p.csv').read_bytes()
    assert 'int8' in str(log) and 'val_prec5' in str(log)
    with pytest.raises(ValueError):
        log.log('too', 'few')


def test_tracker_writes_what_jax_writes(tmp_path):
    args = argparse.Namespace(arch='resnet18', qtype='int4', kld_threshold=False)
    out = {}
    for name, cls in (('jax', JMetricsTracker), ('port', MetricsTracker)):
        with cls(str(tmp_path / name), 'exp', args, 'run') as t:
            t.log_metric('top1', 12.5)
            t.log_metric('loss', 3, step='auto')
            t.log_metric('loss', 2, step='auto')
            t.log_metric('ent', 3.0, meter_id='entropy', weight=2.0)
            t.log_metric('ent', 1.0, meter_id='entropy', weight=1.0)
        (run,) = os.listdir(tmp_path / name / 'exp')
        assert run.startswith('run_')
        d = tmp_path / name / 'exp' / run
        recs = [json.loads(ln) for ln in (d / 'metrics.jsonl').read_text().splitlines()]
        out[name] = ((d / 'params.json').read_text(),
                     [{k: v for k, v in r.items() if k != 't'} for r in recs])
    assert out['port'] == out['jax']
    assert out['port'][1][-1] == {'key': 'avg.entropy', 'value': pytest.approx(7.0 / 3.0)}


def test_results_log_writes_what_jax_writes(tmp_path):
    rows = [dict(bits=4, top1=0.125, name='a'), dict(bits=8, top1=71.123456789, name='b')]
    j_log, log = JResultsLog(str(tmp_path / 'jax' / 'r')), ResultsLog(str(tmp_path / 'port' / 'r'))
    for r in rows:
        j_log.add(**r)
        log.add(**r)
    j_log.save()
    log.save()
    assert (tmp_path / 'port' / 'r.csv').read_bytes() == (tmp_path / 'jax' / 'r.csv').read_bytes()
    a = json.loads((tmp_path / 'port' / 'r.json').read_text())
    b = json.loads((tmp_path / 'jax' / 'r.json').read_text())
    assert [list(r) for r in a] == [list(r) for r in b]
    for ra, rb in zip(a, b):
        for k in ra:
            assert ra[k] == pytest.approx(rb[k], rel=1e-9) if isinstance(rb[k], float) \
                else ra[k] == rb[k]
    loaded = ResultsLog(str(tmp_path / 'port' / 'r')).load()
    assert loaded.rows == j_log.load().df.to_dict('records') == rows
    png = log.plot('bits', 'top1')
    assert png is None or os.path.exists(png)
    assert 'top1' in str(log)


def test_results_log_missing_values_like_pandas(tmp_path):
    """Rows with differing keys: the columns in first-seen order, a missing
    value empty in the CSV and null in the JSON, as pandas writes them."""
    j_log, log = JResultsLog(str(tmp_path / 'jax' / 'r')), ResultsLog(str(tmp_path / 'port' / 'r'))
    for r in (dict(a='x'), dict(b='y', a='z')):
        j_log.add(**r)
        log.add(**r)
    j_log.save()
    log.save()
    assert (tmp_path / 'port' / 'r.csv').read_bytes() == (tmp_path / 'jax' / 'r.csv').read_bytes()
    assert json.loads((tmp_path / 'port' / 'r.json').read_text()) == \
        json.loads((tmp_path / 'jax' / 'r.json').read_text())
