"""``chip_smoke.py``'s ``cli_path`` phase rehearsed on the CPU at resnet18
64x64, batch 2: every CLI run, check and launch prediction of the phase, with
a stand-in for the fake-quant kernel's launch (the plain version's result,
counted by mode).  On the card the phase runs ResNet-50 at 224x224 through
the kernel itself."""

import pytest
import torch

import chip_smoke
from cnn_quantization_tpu_torch.cli import inference_sim
from cnn_quantization_tpu_torch.ops.kernels import fake_quant as fq
from cnn_quantization_tpu_torch.utils import counters


@pytest.fixture()
def stand_in_kernel(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs six test files at once
    plain, plain_sem = fq.fake_quant_fused_plain, fq.fake_quant_kernel_semantics_plain

    def launch(x, p0, p1, qmax, channel_dim, mode, seed=0):
        counters.add('fake_quant')
        return x   # the result was computed by the plain version below

    def fused(x, delta, offset, qmax, *, channel_dim=None, stochastic=False, seed=0):
        out = plain(x, delta, offset, qmax, channel_dim=channel_dim, stochastic=stochastic,
                    seed=seed)
        return fq.launch(out, None, None, None, channel_dim,
                         fq.STOCHASTIC if stochastic else fq.AFFINE, seed)

    def semantics(x, delta, offset, num_bits):
        return fq.launch(plain_sem(x, delta, offset, num_bits), None, None, None, None, fq.MINMAX)

    monkeypatch.setattr(fq, 'launch', launch)
    monkeypatch.setattr(fq, 'fake_quant_fused', fused)
    monkeypatch.setattr(fq, 'fake_quant_kernel_semantics_fused', semantics)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    real_main = inference_sim.main
    monkeypatch.setattr(inference_sim, 'main',
                        lambda argv: real_main(list(argv) + ['--device', 'cpu']))
    monkeypatch.delenv('IMAGENET_DIR', raising=False)
    yield
    torch.set_num_threads(n)


def test_cli_path_phase_on_cpu(stand_in_kernel, capsys):
    rep = chip_smoke.cli_path(torch.device('cpu'), 'cpu', arch='resnet18', size=64, batch=2)
    assert rep['sites'] == 23 and rep['launches'] > 0
    # resnet18: 21 weights, 23 sites; mid-tread launches only at the
    # classifier weight and the two per-tensor sites (maxpool, classifier)
    assert rep['mid_tread']['launches'] == {'affine': 1, 'reference_per_tensor': 4}
    assert rep['kld_use_frozen']['launches'] == {'affine': 21 + 2 * 23}
    assert rep['kld_use_dynamic']['held_to_plain'] == {'calls': 21, 'max_abs_err': 0.0}
    assert rep['stochastic']['stochastic_launches_per_forward'] == 22
    assert 0.0 < rep['mid_tread']['avg_entropy'] <= 4.0
    assert '"phase": "cli_path"' in capsys.readouterr().out
