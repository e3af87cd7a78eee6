"""The port's CLI in-process on the CPU, and the port's isolation from JAX.

The CLI runs the README's ResNet commands at resnet18/64x64 on synthetic
data; every flag outside this slice exits naming its ROADMAP item.  The
isolation test imports every module of the port in a fresh interpreter in
which ``jax`` cannot be imported, and checks that nothing of the JAX package
was loaded; a source scan backs it up, ``chip_smoke.py`` included.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from cnn_quantization_tpu_torch.cli.inference_sim import main

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / 'cnn_quantization_tpu_torch'
# the port's Python sources; the kernel build directory holds no source
PORT_SOURCES = sorted(p for p in PORT.rglob('*.py') if '_build' not in p.parts)

BASE = ['--device', 'cpu', '-a', 'resnet18', '-b', '2', '--subset', '4',
        '--input_size', '64', '--data', '/nonexistent']
HEADLINE = ['-pcq_w', '-pcq_a', '-sh', '--qtype', 'int4', '-qw', 'int4',
            '-c', 'laplace', '-baa', '-baw', '-bcw']


@pytest.fixture()
def cli_env(tmp_path, monkeypatch):
    """Isolated HOME (the stats artifact's default home) and cwd."""
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.delenv('IMAGENET_DIR', raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _last_json(capsys):
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


def test_cli_headline(cli_env, capsys):
    assert main(BASE + HEADLINE) == 0
    _, res = _last_json(capsys)
    assert {'top1', 'top5', 'loss', 'images_per_sec'} <= set(res)


def test_cli_collect_then_use(cli_env, capsys):
    common = BASE + HEADLINE
    assert main(common + ['-sm', 'collect', '-ac', '-cs', '4']) == 0
    path = cli_env / 'mxt-sim-tpu' / 'statistics' / 'per_channel' / 'resnet18.npz'
    assert path.exists(), 'collect mode must write the stats artifact'
    assert main(common + ['-sm', 'use']) == 0
    out, res = _last_json(capsys)
    assert 'Loaded statistics for 23 sites' in out
    assert 'Froze qparams for 23 sites' in out
    assert res['loss'] > 0


def test_cli_weights_fold_bn_like_jax(cli_env, capsys):
    """``--weights`` loads a torchvision checkpoint with BN folded exactly as
    the JAX package's importer folds it."""
    import numpy as np
    import torch
    from cnn_quantization_tpu.utils.torch_import import fold_bn_state as j_fold
    from cnn_quantization_tpu_torch.utils.checkpoint import fold_bn_state
    from _torch_parity import torchvision_like_state

    state = torchvision_like_state('resnet18')
    folded, bns = fold_bn_state(state)
    want, j_bns = j_fold(state)
    assert bns == j_bns and set(folded) == set(want) and len(bns) == 20
    for k in want:
        np.testing.assert_array_equal(folded[k], want[k])
    path = cli_env / 'resnet18.pth'
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    assert main(BASE + HEADLINE + ['--weights', str(path)]) == 0
    assert 'random init' not in capsys.readouterr().out


@pytest.mark.parametrize('flag,item', [
    (['--serving_int8', '--serving_packed'], 'item 6'),
    (['--serving_packed_stages', '1,2'], 'item 6'),
    (['-kld'], 'item 8'),
    (['-mtq'], 'item 12'),
    (['-ep'], 'item 14'),
    (['-sf', 'other'], 'item 14'),
    (['-s'], 'item 14'),
    (['-p', '5'], 'item 14'),
    (['--mesh_model', '2'], 'item 9'),
    (['-j', '8'], 'item 13'),
])
def test_cli_unported_flags_exit(cli_env, flag, item):
    with pytest.raises(SystemExit, match=item):
        main(BASE + ['--qtype', 'int4'] + flag)


def test_cli_existing_imagenet_dir_exits(cli_env):
    args = [a if a != '/nonexistent' else str(cli_env) for a in BASE]
    with pytest.raises(SystemExit, match='item 13'):
        main(args + ['--qtype', 'int4'])


def test_port_imports_no_jax():
    """Every module of the port imports with ``jax`` unimportable, and no
    module of the JAX package is loaded."""
    modules = sorted(
        'cnn_quantization_tpu_torch.' + '.'.join(p.relative_to(PORT).with_suffix('').parts)
        for p in PORT_SOURCES if p.name != '__init__.py')
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'cnn_quantization_tpu' or "
            "m.startswith(('cnn_quantization_tpu.', 'jax.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) > 20


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = PORT_SOURCES + [REPO / 'chip_smoke.py']
    for path in files:
        for name in _imported_roots(path):
            root = name.split('.')[0]
            assert root not in ('jax', 'jaxlib', 'flax', 'cnn_quantization_tpu'), \
                f'{path.relative_to(REPO)} imports {name}'
