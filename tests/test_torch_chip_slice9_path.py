"""``chip_smoke.py``'s slice-9 phases (``data_path``, ``parallel_path``,
``tools_path``, with slice 10's sharded checkpoints and ``cost_analysis``)
rehearsed on the CPU at 64x64: every run, check and launch
prediction of the phases, with stand-ins for the kernels' launches (the plain
version's result, counted by mode or route as the kernel's own wrapper
counts; ``tests/test_torch_chip_zoo_path.py``).  The two-rank runs of
``parallel_path`` start their own processes (gloo on the CPU), where the
int8 wrappers' calls by route stand in for the launches.  On the card the
phases run ResNet-50 at 224x224 and batch 64 through the kernels
themselves."""

import json

import torch

import chip_smoke
from test_torch_chip_zoo_path import stand_in_kernels  # noqa: F401  (a fixture)


def _phase(out, name):
    return json.loads(next(ln for ln in out.splitlines() if f'"phase": "{name}"' in ln))


def test_data_path_phase_on_cpu(stand_in_kernels, capsys):  # noqa: F811
    rep = chip_smoke.data_path(torch.device('cpu'), 'cpu', arch='resnet18', size=64, batch=4,
                               n_images=8)
    assert rep['logits_equal_direct'] and rep['launches'] > 0
    assert rep['use']['launches']['affine'] == 21 + 23 * 2     # weights, then 23 sites x 2
    assert 'PIL' in rep['folder_without_pil_exit']
    assert _phase(capsys.readouterr().out, 'data_path')['top5'] == rep['top5']


def test_tools_path_phase_on_cpu(stand_in_kernels, capsys, monkeypatch):  # noqa: F811
    # two of the runbook's six configs (the headline, which the phase also
    # runs alone, and one with its collect pass); tests/test_torch_tools.py
    # runs all six
    from cnn_quantization_tpu_torch.cli import golden_repro
    monkeypatch.setattr(golden_repro, 'GOLDEN', golden_repro.GOLDEN[1:3])
    rep = chip_smoke.tools_path(torch.device('cpu'), 'cpu', arch='squeezenet1_1', golden_size=64,
                                golden_batch=2, ste_shape=(2, 8, 5, 5))
    km = rep['kmeans']
    assert km['quantize']['max_distinct_per_leaf'] <= 16 and km['quantize']['leaves'] == 25
    assert sorted(km) == ['clip', 'clip_bcorr', 'quantize', 'quantize_bcorr']
    assert rep['golden']['smoke']['configs'] == ['w4a4_headline',
                                                 'w4a4_headline_offline_stats']
    assert rep['ste']['launches'] == 1
    cost = rep['cost_analysis']     # slice 10: one W8A8 serving forward
    assert cost['flops'] == cost['count_work_ops'] > 0
    assert cost['bytes_accessed'] == cost['count_work_bytes']
    assert _phase(capsys.readouterr().out, 'tools_path')['launches'] == rep['launches']


def test_parallel_path_phase_on_cpu(stand_in_kernels, capsys):  # noqa: F811
    rep = chip_smoke.parallel_path(torch.device('cpu'), 'cpu', arch='resnet18', size=64,
                                   batch=4)
    one = rep['one_rank']
    assert one['backend'] == 'gloo'
    assert one['w4a4_frozen']['logits_equal'] and one['w8a8_serving']['logits_equal']
    assert one['w4a4_frozen']['launches'] == {'fake_quant': 23 * 2}
    for mesh in ('data2_model1', 'data1_model2'):
        entry = rep['two_ranks'][mesh]
        for r in (0, 1):
            s2d = entry[f'rank{r}_s2d_stem']
            assert s2d['logits_equal'] and s2d['launches'] == s2d['predicted']
            # ResNet-18 at 64x64: the s2d stem on the implicit GEMM, 16 3x3 convs
            # and 3 strided 1x1 downsamples on the im2col route, the classifier
            assert s2d['predicted'] == {'implicit_gemm': 2, 'im2col_wgmma': 38, 'wgmma': 2}
        # slice 10: the ranks' DCP checkpoint, whole and by model index
        ck = entry['checkpoint']
        assert ck['whole_equal'] and ck['slices_equal'] == [True] * int(mesh[-1])
        assert ck['rank0']['slices_equal'] and ck['rank1']['slices_equal']
    assert one['backend'] == 'gloo' and rep['checkpoint_one_rank']['logits_equal']
    assert _phase(capsys.readouterr().out, 'parallel_path')['batch'] == 4
