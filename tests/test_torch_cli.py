"""The port's CLI in-process on the CPU, and the port's isolation from JAX.

The CLI runs the README's ResNet commands at resnet18/64x64 on synthetic
data; a misuse of a flag exits saying what it needs.  The
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


# the test ids are kept as they were when these flags were still unported
# ("flag0-item 6" ... "flag9-item 13"): the flags run now, and what is left to
# exit for is their misuse (which the JAX CLI silently ignores or fails on
# deeper down): a mesh larger than 1x1 without a process group, the packed
# trunk on a model axis, a class-folder tree on a machine without PIL
@pytest.mark.parametrize('flag,item', [
    (['--serving_packed'], '--serving_packed needs --serving_int8'),
    (['--serving_int8', '--serving_packed_stages', '1,2'],
     '--serving_packed_stages needs --serving_packed'),
    (['-kld'], '-kld quantizes from the thresholds of -sm collect -kld'),
    (['--mesh_data', '2'], 'mesh larger than 1x1 needs a process group'),
    (['-ct'], 'custom_test needs --order_file or stats'),
    (['-sm', 'use'], 'no stats at'),
    (['--serving_int8', '--serving_packed', '--mesh_model', '2'],
     'cannot run with --mesh_model > 1'),
    (['--weights', 'model.ckpt'], 'an .npz parameter tree'),
    (['--mesh_model', '2'], 'mesh larger than 1x1 needs a process group'),
    (['-j', '8', '--data', 'TREE'], r'needs PIL.*\.npz'),
], ids=['flag0-item 6', 'flag1-item 6', 'flag2-item 8', 'flag3-item 12', 'flag4-item 14',
        'flag5-item 14', 'flag6-item 14', 'flag7-item 14', 'flag8-item 9', 'flag9-item 13'])
def test_cli_unported_flags_exit(cli_env, monkeypatch, flag, item):
    if 'TREE' in flag:
        flag = [str(_image_tree(cli_env)) if f == 'TREE' else f for f in flag]
        monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(SystemExit, match=item):
        main(BASE + ['--qtype', 'int4'] + flag)


def _image_tree(root):
    """A class-folder tree of one PNG (written with PIL)."""
    import numpy as np
    from PIL import Image
    (root / 'val' / 'n01').mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(root / 'val' / 'n01' / 'a.png')
    return root


PACKED = ['--device', 'cpu', '-a', 'resnet50', '-b', '2', '--subset', '2', '--input_size', '64',
          '--data', '/nonexistent', '--qtype', 'int4', '-qw', 'int4', '--serving_int8']


@pytest.mark.parametrize('extra,gemms', [
    (['--serving_packed'], 36),
    (['--serving_packed', '--serving_packed_stages', '1,3'], 20),
], ids=['all_stages', 'stages_1_3'])
def test_cli_serving_packed(cli_env, capsys, monkeypatch, extra, gemms):
    """``--serving_int8 --serving_packed [--serving_packed_stages 1,3]`` runs
    ResNet-50 at 64x64 on the CPU, prints the result line, and the one
    evaluation batch goes through the int4 GEMM as often as the stages say."""
    from cnn_quantization_tpu_torch.ops.kernels import int4_matmul as i4
    calls = []
    real = i4.int4_matmul
    monkeypatch.setattr(i4, 'int4_matmul', lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    assert main(PACKED + extra) == 0
    out, res = _last_json(capsys)
    assert 'serving-int8: calibrating frozen activation scales' in out
    assert {'top1', 'top5', 'loss', 'images_per_sec'} <= set(res)
    assert res['loss'] > 0 and len(calls) == gemms


@pytest.mark.parametrize('stages', [',', '0,5', '1,x'],
                         ids=['empty', 'out_of_range', 'not_a_number'])
def test_cli_serving_packed_stages_must_list_stages(cli_env, stages):
    with pytest.raises(SystemExit, match='--serving_packed_stages must list stages 1-4'):
        main(BASE + ['--qtype', 'int4', '-qw', 'int4', '--serving_int8', '--serving_packed',
                     '--serving_packed_stages', stages])


def test_cli_existing_imagenet_dir_exits(cli_env, monkeypatch):
    """An existing ImageNet tree is read (``--data``), but it needs PIL to
    decode: without PIL the CLI exits naming it and the ``.npz`` route."""
    args = [a if a != '/nonexistent' else str(_image_tree(cli_env)) for a in BASE]
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(SystemExit, match=r'needs PIL.*\.npz'):
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
