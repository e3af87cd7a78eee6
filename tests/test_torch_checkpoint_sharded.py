"""Sharded parameter checkpoints, ``utils/checkpoint.save_params_sharded``/
``load_params_sharded`` on ``torch.distributed.checkpoint`` (DCP), the
port's counterpart of the JAX package's ``save_params_orbax``/
``load_params_orbax``:

  * one process: the simulation tree (float32, and cast to bfloat16) and the
    W8A8 serving tree (int8 codes in channels_last memory, float32 scales,
    the float stem, and uint8 packed int4 codes) come back bit for bit, each
    entry in its dtype, shape and strides;
  * two gloo ranks at mesh 1x2 (tests/_torch_parallel_worker.py, 120 s
    timeout each) save their slices of the serving tree together: the
    checkpoint reads back whole equal to the unsharded tree, and by each
    model index equal to ``parallel.shard_params``; each rank reads its own
    slices back equal (checked in the worker).
"""

import subprocess
import sys

import pytest
import torch

import _torch_parallel_worker as worker
from chip_smoke import same_tree
from test_torch_parallel import REPO, _communicate, _env, _free_port

from cnn_quantization_tpu_torch.ops.kernels.int4_matmul import pack_int4
from cnn_quantization_tpu_torch.parallel import Mesh, shard_params
from cnn_quantization_tpu_torch.utils.checkpoint import (load_params_sharded,
                                                         save_params_sharded)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs six test files at once
    yield
    torch.set_num_threads(n)


def tree(name):
    model, sp = worker.serving_tree()
    if name == 'serving':
        # packed int4 codes as the int4 GEMM's bytes: rows of 256 codes
        for k in ('fc.weight', 'layer4.1.conv2.weight'):
            codes = sp[k].reshape(sp[k].shape[0], -1).clamp(-8, 7)
            sp[f'{k}.packed'] = pack_int4(codes).view(torch.uint8)
        assert {v.dtype for v in sp.values()} == {torch.int8, torch.uint8, torch.float32}
        return sp
    params = dict(model.state_dict())
    if name == 'simulation_bf16':
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    return params


@pytest.mark.parametrize('name', ['simulation', 'simulation_bf16', 'serving'])
def test_one_process_round_trip_is_bit_identical(tmp_path, name):
    params = tree(name)
    save_params_sharded(str(tmp_path / name), params)
    assert same_tree(load_params_sharded(str(tmp_path / name), device='cpu'), params)


def test_two_ranks_save_slices_that_load_whole_and_sliced(tmp_path):
    path = str(tmp_path / 'mesh_1x2')
    init = f'tcp://127.0.0.1:{_free_port()}'
    procs = [subprocess.Popen([sys.executable, str(REPO / 'tests' / '_torch_parallel_worker.py'),
                               init, '2', str(r), '1', '2', path, 'checkpoint'],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env()) for r in range(2)]
    _communicate(procs)
    model, sp = worker.serving_tree()
    assert same_tree(load_params_sharded(path, device='cpu'), sp)
    for m in range(2):
        mesh = Mesh(data=1, model=2, model_index=m)
        got = load_params_sharded(path, mesh, model, device='cpu')
        want = shard_params(sp, mesh, model)
        assert got['fc.weight'].shape[0] == 500
        assert same_tree(got, want)
