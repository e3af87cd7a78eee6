"""The port's parallel layer over ``torch.distributed``: two gloo processes
on the CPU for each of the meshes data=2/model=1 and data=1/model=2, held
against one process at the JAX package's bars (tests/test_parallel.py):

  * frozen qparams and use-stats under DP: exact (logits equal);
  * TP with frozen qparams: counts equal, loss within rtol 1e-4;
  * dynamic quantization under DP: counts within 1, loss within 5e-2 (the
    global statistics reassociate sums across ranks; 4-bit rounding
    amplifies that);
  * calibration statistics under DP: rtol 1e-3 / atol 1e-4 against one
    process, and against the JAX package's single-device statistics of the
    same weights and images;
  * prepared W8A8 serving with frozen scales under DP and TP: logits equal.

The workers (tests/_torch_parallel_worker.py) run with a 120 s timeout each.
Also the mesh rules (sharding, batch split, host shard) against the JAX
package's, and the CLI under a two-rank process group.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from cnn_quantization_tpu.parallel.distributed import host_shard as j_host_shard

from cnn_quantization_tpu_torch.models import build_model
from cnn_quantization_tpu_torch.parallel import Mesh, make_mesh, param_sharding, shard_params
from cnn_quantization_tpu_torch.parallel import distributed
from cnn_quantization_tpu_torch.parallel.mesh import shard_batch

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 120
MESHES = {'dp': (2, 1), 'tp': (1, 2)}


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK')}
    env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get('PYTHONPATH', ''),
               OMP_NUM_THREADS='1', **extra)
    return env


def _communicate(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, f'rank failed:\n{err[-3000:]}'
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    """{'single': ..., 'dp': ..., 'tp': ...}: every scenario's results; the
    two meshes' four ranks run at once."""
    tmp = tmp_path_factory.mktemp('parallel')
    procs, paths = [], {}
    for name, (data, model) in MESHES.items():
        port, paths[name] = _free_port(), tmp / f'{name}.npz'
        procs += [subprocess.Popen(
            [sys.executable, str(REPO / 'tests' / '_torch_parallel_worker.py'),
             f'tcp://127.0.0.1:{port}', '2', str(rank), str(data), str(model), str(paths[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)
            for rank in range(2)]
    n = torch.get_num_threads()
    try:
        out = {'single': worker.scenarios(make_mesh())}
    finally:
        torch.set_num_threads(n)
    _communicate(procs)
    for name, path in paths.items():
        entry = out.setdefault(name, {})
        with np.load(path) as z:
            for key in z.files:
                scenario, k = key.split('|', 1)
                entry.setdefault(scenario, {})[k] = z[key]
    return out


def _counts_loss(got, want, loss_rtol, counts_atol=0):
    assert abs(float(got['top1']) - want['top1']) <= counts_atol
    assert abs(float(got['top5']) - want['top5']) <= counts_atol
    np.testing.assert_allclose(float(got['loss']), want['loss'], rtol=loss_rtol)


@pytest.mark.parametrize('mesh,scenario', [('dp', 'frozen'), ('dp', 'use_stats'),
                                           ('dp', 'serving'), ('tp', 'serving')])
def test_sharded_logits_equal_single_process(results, mesh, scenario):
    got, want = results[mesh][scenario], results['single'][scenario]
    np.testing.assert_array_equal(got['logits'], want['logits'])
    _counts_loss(got, want, loss_rtol=1e-6)


@pytest.mark.parametrize('scenario', ['frozen', 'use_stats'])
def test_tp_matches_single_process(results, scenario):
    _counts_loss(results['tp'][scenario], results['single'][scenario], loss_rtol=1e-4)


def test_dp_dynamic_uses_global_statistics(results):
    _counts_loss(results['dp']['dynamic'], results['single']['dynamic'], loss_rtol=5e-2,
                 counts_atol=1)


def test_dp_collect_stats_are_global(results):
    got, want = results['dp']['collect'], results['single']['collect']
    assert sorted(got) == sorted(want) and len(want) > 100
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-3, atol=1e-4, err_msg=key)


def test_dp_collect_stats_match_jax_single_device(results):
    """The same weights and images through the JAX package's collect step:
    the port's statistics under DP equal JAX's single-device ones at the JAX
    DP bar (the two packages' float convs differ in the last bits)."""
    import jax
    from cnn_quantization_tpu.engine import QuantEngine as JEngine
    from cnn_quantization_tpu.engine import QuantPolicy as JPolicy
    from cnn_quantization_tpu.models import build_model as j_build_model
    from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy
    from cnn_quantization_tpu_torch.utils.flax_params import flax_from_state_dict
    model, meta = build_model(worker.ARCH, device='cpu', seed=0, input_size=worker.SIZE)
    pq = QuantEngine(model, QuantPolicy(arch=worker.ARCH, **worker.HEADLINE), meta) \
        .quantize_params(dict(model.state_dict()))
    j_model, j_meta = j_build_model(worker.ARCH)
    j_eng = JEngine(j_model, JPolicy(arch=worker.ARCH, **worker.HEADLINE), j_meta)
    _, want = jax.device_get(j_eng.jit_collect()(flax_from_state_dict(pq, worker.ARCH),
                                                 worker.images(11)[0]))
    got = results['dp']['collect']
    for site, entry in want.items():
        for stat, v in entry.items():
            np.testing.assert_allclose(got[f'{site}/{stat}'], np.asarray(v), rtol=1e-3,
                                       atol=1e-4, err_msg=f'{site}/{stat}')


def test_mesh_without_process_group():
    assert make_mesh() == Mesh() and make_mesh(1, 1).shape == {'data': 1, 'model': 1}
    with pytest.raises(ValueError, match='needs a process group'):
        make_mesh(data=2)
    assert distributed.global_mesh() == Mesh()


def test_param_sharding_rule():
    """Conv and linear weights split along output channels (axis 0) with their
    bias and ``w_scale`` where the model axis divides them; a depthwise conv,
    BN entries and everything else replicated."""
    model, _ = build_model('mobilenet_v2', device='cpu', input_size=32)
    params = dict(model.state_dict())
    spec = param_sharding(Mesh(data=1, model=2, model_index=1), params, model)
    sharded = {k for k, v in spec.items() if v == 'model'}
    assert 'features.0.0.weight' in sharded and 'classifier.1.weight' in sharded
    assert 'classifier.1.bias' in sharded
    assert 'features.1.conv.0.0.weight' not in sharded          # depthwise 3x3
    assert not any('running_mean' in k for k in sharded)
    shard = shard_params(params, Mesh(data=1, model=2, model_index=1), model)
    w, full = shard['classifier.1.weight'], params['classifier.1.weight']
    assert w.shape == (500, 1280) and torch.equal(w, full[500:])
    assert w.data_ptr() != full[500:].data_ptr() and w.is_contiguous()
    assert param_sharding(Mesh(), params, model) == {k: None for k in params}


def test_shard_batch_and_host_shard_match_jax():
    x, y = np.arange(24).reshape(8, 3), np.arange(8)
    parts = [shard_batch(Mesh(data=4, data_index=i), x, y) for i in range(4)]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), x)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), y)
    with pytest.raises(ValueError, match='does not split'):
        shard_batch(Mesh(data=3), x, y)
    samples = list(range(10))
    for count in (1, 3, 4):
        for i in range(count):
            assert distributed.host_shard(samples, process_index=i, process_count=count) == \
                j_host_shard(samples, process_index=i, process_count=count)
    assert distributed.host_shard(samples) == samples


def test_init_distributed_and_global_batch(monkeypatch):
    monkeypatch.delenv('MASTER_ADDR', raising=False)
    assert distributed.init_distributed(device='cpu') is False
    images, labels = distributed.make_global_batch(
        Mesh(), np.zeros((2, 4, 4, 3), np.float32), np.array([1, 2], np.int32), device='cpu')
    assert images.dtype == torch.float32 and labels.dtype == torch.int64
    monkeypatch.setenv('LOCAL_RANK', '1')
    assert distributed.local_device('cpu') == torch.device('cpu')


def test_cli_under_two_ranks_equals_one_process(tmp_path):
    """``inference_sim --mesh_model 2`` and ``--mesh_data 2`` under a
    two-rank gloo process group (torchrun's environment): every rank prints
    the single process's W8A8 serving result."""
    base = [sys.executable, '-m', 'cnn_quantization_tpu_torch.cli.inference_sim', '--device',
            'cpu', '-a', 'resnet18', '-b', '4', '--subset', '8', '--input_size', '32',
            '--qtype', 'int8', '-qw', 'int8', '--serving_int8']

    def last_json(out):
        return json.loads(out.strip().splitlines()[-1])

    def start(argv, **env):
        return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=tmp_path, env=_env(HOME=str(tmp_path), **env))

    # the one process and both meshes' ranks at once
    procs = [start(base)]
    meshes = (['--mesh_model', '2'], ['--mesh_data', '2'])
    for flags in meshes:
        port = str(_free_port())
        procs += [start(base + flags, MASTER_ADDR='127.0.0.1', MASTER_PORT=port,
                        WORLD_SIZE='2', RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)]
    want, *ranks = [last_json(out) for out in _communicate(procs)]
    for i, got in enumerate(ranks):
        flags = meshes[i // 2]
        assert got['top1'] == want['top1'] and got['top5'] == want['top5'], flags
        assert abs(got['loss'] - want['loss']) <= 1e-4 * abs(want['loss']), (flags, got)


@pytest.mark.parametrize('flags,mesh,named', [
    (['-sm', 'collect', '-kld'], (1, 2), ['-sm collect -kld']),
    (['-ms', '-dd', 'dump'], (1, 2), ['-ms', '-dd']),
    (['-mtq', '-ra', '2.0', '-me'], (2, 1), ['-me', '-mtq', '-ra']),
    (['-mtq', '-ra', '2.0'], (1, 2), []),
])
def test_cli_runs_the_sharded_path_does_not_cover(flags, mesh, named):
    """Under a process group the CLI exits for the runs the sharded path does
    not cover (the first it names): the KLD capture, -ms, -dd, -me, and on a
    data axis of more than one rank -mtq and -ra."""
    from cnn_quantization_tpu_torch.cli import inference_sim
    args = inference_sim.build_parser().parse_args(flags)
    got = [flag for flag, _ in inference_sim._unsharded(args, Mesh(*mesh))]
    assert got == named
