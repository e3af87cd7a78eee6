"""The port's ``inference_sim`` on the rest of the zoo against the jitted
JAX CLI on the CPU, same ``.npz`` weights and synthetic batches, within the
bars of ``tests/_torch_cli_pair.py`` (top-1/top-5 equal, loss within 5e-2
relative, entropy rate within 1e-2 bits): VGG-16 at 32x32 on the paper's
fifth experiment (mid-tread quantization with bit allocation at a 5.3-bit
target, the entropy rate measured), and Inception-v3 at 75x75 (the meta's
299 cut down; the two 8-bit stem convs by name) on W8A8 true-int serving.
Both CLIs build the model for ``--input_size``; the weights are the JAX
importer's tree of a torchvision-style checkpoint at that size."""

import numpy as np
import pytest
import torch

from cnn_quantization_tpu.models import build_model as j_build_model
from cnn_quantization_tpu.utils.checkpoint import save_params_npz

from _torch_cli_pair import assert_results_close, run_both
from _torch_parity import import_params, torchvision_like_state

CASES = {
    'vgg16': (32, ['-pcq_w', '-pcq_a', '--qtype', 'int4', '-qw', 'int4', '-c', 'laplace',
                   '-baa', '-baw', '-bcw', '-bata', '5.3', '-batw', '5.3', '-mtq', '-me']),
    'inception_v3': (75, ['--qtype', 'int8', '-qw', 'int8', '--serving_int8']),
}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs six test files at once
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('arch', sorted(CASES))
def test_cli_matches_jax_cli(arch, tmp_path, monkeypatch, record_property):
    size, flags = CASES[arch]
    fold = j_build_model(arch)[1].fold_bn
    weights = str(tmp_path / f'{arch}.npz')
    save_params_npz(weights, import_params(arch, torchvision_like_state(arch, size=size), fold,
                                           size))
    argv = ['-a', arch, '-b', '2', '--subset', '4', '--input_size', str(size),
            '--data', '/nonexistent', '--device', 'cpu', '--weights', weights] + flags
    out = run_both(argv, tmp_path, monkeypatch)
    assert_results_close(out)
    res = out['port'][2]
    record_property(f'{arch}_cli', res)
    assert np.isfinite(res['loss']) and res['images_per_sec'] > 0
    if '-me' in flags:
        assert 0.0 < res['avg_entropy'] <= 4.0


def test_serving_packed_falls_back_without_bottleneck_trunks(tmp_path, monkeypatch):
    """``--serving_packed`` on an architecture without Bottleneck trunks runs
    the plain serving path, as the JAX CLI does: the same result as without
    the flag (no int4 GEMM engages; ROADMAP Queue 3)."""
    from cnn_quantization_tpu_torch.cli import inference_sim
    from _torch_cli_pair import run
    argv = ['-a', 'squeezenet1_1', '-b', '2', '--subset', '2', '--input_size', '64',
            '--data', '/nonexistent', '--device', 'cpu', '--qtype', 'int4', '-qw', 'int4',
            '--serving_int8']
    plain = run(inference_sim.main, argv, tmp_path / 'plain', monkeypatch)
    packed = run(inference_sim.main, argv + ['--serving_packed'], tmp_path / 'packed',
                 monkeypatch)
    assert plain[0] == packed[0] == 0 and plain[2] is not None
    assert {k: v for k, v in packed[2].items() if k != 'images_per_sec'} == \
        {k: v for k, v in plain[2].items() if k != 'images_per_sec'}
