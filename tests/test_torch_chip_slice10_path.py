"""``chip_smoke.py``'s slice-10 phase ``resume_path`` rehearsed on the CPU at
64x64 and batch 2: every run, check and launch prediction of the phase, with
stand-ins for the kernels' launches (``tests/test_torch_chip_zoo_path.py``).
On the card the phase runs ResNet-50 at 224x224 and batch 64 through the
kernels themselves.  The phase's additions to ``parallel_path`` and
``tools_path`` are rehearsed by ``tests/test_torch_chip_slice9_path.py``."""

import json

import torch

import chip_smoke
from test_torch_chip_zoo_path import stand_in_kernels  # noqa: F401  (a fixture)


def test_resume_path_phase_on_cpu(stand_in_kernels, capsys):  # noqa: F811
    rep = chip_smoke.resume_path(torch.device('cpu'), 'cpu', arch='resnet18', size=64, batch=2)
    for name, per_forward in (('w4a4_frozen', {'fake_quant': 23}),
                              ('w8a8_serving', {'int8_gemm': 1, 'int8_conv': 19})):
        runs = rep[name]
        # 6 batches; the interrupted run dies asking for batch 3 with a
        # checkpoint after batch 2, so the resumed run evaluates 4
        for run, n in (('uninterrupted', 6), ('interrupted', 3), ('resumed', 4)):
            assert runs[run]['launches'] == {k: v * n for k, v in per_forward.items()}
        assert runs['uninterrupted']['reads_in_loop'] == 0
        assert runs['interrupted']['reads_in_loop'] == 4
        assert runs['interrupted']['file']['batches'] == 2
        assert runs['resumed']['top5'] == runs['uninterrupted']['top5']
    out = capsys.readouterr().out
    line = json.loads(next(ln for ln in out.splitlines() if '"phase": "resume_path"' in ln))
    assert line['launches'] == rep['launches']
