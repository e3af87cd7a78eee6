"""The port's ImageNet loader, transforms and dataset helpers against the
JAX package's, on the same images and seeds.

Both are host code (numpy + PIL), so the bar is bit for bit: the same
samples, labels and float32 arrays.  The images are written into
``tmp_path`` with PIL: PNG and JPEG, landscape, portrait and square, RGB,
grayscale and RGBA.  The CLI's ``--data *.npz`` run is held against the JAX
CLI at the CLI parity bar (top-1/top-5 equal, loss within 5e-2,
``tests/_torch_cli_pair.py``).
"""

import sys

import numpy as np
import pytest
from PIL import Image

from cnn_quantization_tpu.data import dataset as j_dataset
from cnn_quantization_tpu.data import imagenet as j_imagenet
from cnn_quantization_tpu.data import preprocess as j_pre

from cnn_quantization_tpu_torch.cli import inference_sim as cli
from cnn_quantization_tpu_torch.data import dataset, imagenet, preprocess
from _torch_cli_pair import LOSS_RTOL, run, run_both, write_weights

# (class, file name, size (w, h), PIL mode)
IMAGES = [('n01', 'a.png', (80, 60), 'RGB'), ('n01', 'b.JPEG', (50, 90), 'RGB'),
          ('n01', 'c.jpg', (72, 72), 'L'), ('n02', 'd.png', (97, 70), 'RGBA'),
          ('n02', 'e.jpeg', (66, 120), 'RGB'), ('n02', 'notes.txt', None, None),
          ('n03', 'f.bmp', (70, 64), 'RGB'), ('n03', 'g.png', (64, 81), 'L')]


def _write_tree(root):
    rng = np.random.RandomState(3)
    for cls, name, size, mode in IMAGES:
        d = root / cls
        d.mkdir(parents=True, exist_ok=True)
        if size is None:
            (d / name).write_text('not an image')
            continue
        channels = {'RGB': 3, 'L': 1, 'RGBA': 4}[mode]
        arr = rng.randint(0, 256, (size[1], size[0], channels)).astype(np.uint8)
        Image.fromarray(arr.squeeze(-1) if channels == 1 else arr, mode).save(d / name)
    return root


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp('imagenet') / 'val')


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.float32 and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_find_samples_equal(tree):
    samples = imagenet.find_samples(str(tree))
    assert samples == j_imagenet.find_samples(str(tree))
    assert [label for _, label in samples] == [0, 0, 0, 1, 1, 2, 2]


@pytest.mark.parametrize('crop,resize', [(32, 40), (48, 54), (64, 73)])
def test_load_image_equal(tree, crop, resize):
    for path, _ in imagenet.find_samples(str(tree)):
        got = imagenet._load_image(path, resize, crop)
        assert got.shape == (crop, crop, 3)
        np.testing.assert_array_equal(got, j_imagenet._load_image(path, resize, crop))


@pytest.mark.parametrize('shuffle,limit,workers', [(False, None, 1), (True, 5, 3)])
def test_imagenet_val_batches_equal(tree, shuffle, limit, workers):
    kw = dict(resize=40, crop=32, shuffle=shuffle, seed=7, limit=limit)
    got = imagenet.ImageNetVal(str(tree), 3, workers=workers, **kw)
    want = j_imagenet.ImageNetVal(str(tree), 3, **kw)
    assert len(got) == len(want)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize('route', ['val_subdir', 'folder', 'npz', 'synthetic'])
def test_make_loader_routes_equal(tree, tmp_path, route):
    kw = dict(shuffle=True, limit=5, seed=3, size=32)
    if route == 'val_subdir':
        data = str(tree.parent)
    elif route == 'folder':
        data = str(tree)
    elif route == 'npz':
        rng = np.random.RandomState(0)
        data = str(tmp_path / 'val.npz')
        np.savez(data, images=rng.randn(7, 32, 32, 3).astype(np.float32),
                 labels=rng.randint(0, 1000, 7))
    else:
        data = str(tmp_path / 'missing')
    got, real = imagenet.make_loader(data, 'resnet18', 2, workers=2, **kw)
    want, j_real = j_imagenet.make_loader(data, 'resnet18', 2, **kw)
    assert real == j_real == (route != 'synthetic')
    _assert_batches_equal(got, want)


def test_folder_route_without_pil_names_pil_and_npz(tree, monkeypatch):
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match=r'needs PIL.*\.npz'):
        imagenet.make_loader(str(tree), 'resnet18', 2, size=32)
    # the .npz route needs no decoder; nor does the synthetic fallback
    batches, real = imagenet.make_loader(None, 'resnet18', 2, size=32, limit=4)
    assert not real and len(batches) == 2


def _pil_image(w, h, mode, seed):
    rng = np.random.RandomState(seed)
    channels = {'RGB': 3, 'L': 1}[mode]
    arr = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
    return Image.fromarray(arr.squeeze(-1) if channels == 1 else arr, mode)


TRANSFORMS = [
    ('scale_crop', lambda m: m.scale_crop(32, 40)),
    ('scale_crop_no_resize', lambda m: m.scale_crop(32)),
    ('scale_random_crop', lambda m: m.scale_random_crop(32, 40)),
    ('pad_random_crop', lambda m: m.pad_random_crop(32, 40)),
    ('inception', lambda m: m.inception_preprocess(32)),
    ('inception_color', lambda m: m.inception_preprocess(32, color=True)),
    ('imagenet_eval', lambda m: m.get_transform('imagenet', 32, 40, augment=False)),
    ('imagenet_train', lambda m: m.get_transform('imagenet', 32)),
    ('cifar_train', lambda m: m.get_transform('cifar10')),
    ('mnist_eval', lambda m: m.get_transform('mnist', augment=False)),
]


@pytest.mark.parametrize('name,make', TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
def test_transforms_equal(name, make):
    """Each builder on PIL images (RGB and grayscale, landscape and portrait)
    and on a uint8 array, with equal generators: equal arrays, and the
    generators left in the same state."""
    fn, j_fn = make(preprocess), make(j_pre)
    inputs = [_pil_image(50, 44, 'RGB', 1), _pil_image(41, 60, 'RGB', 2),
              np.asarray(_pil_image(48, 48, 'RGB', 3)), _pil_image(45, 52, 'L', 4)]
    for i, img in enumerate(inputs):
        rng, j_rng = np.random.default_rng(i), np.random.default_rng(i)
        got, want = fn(img, rng), j_fn(img, j_rng)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert rng.random() == j_rng.random()


def test_lighting_and_unknown_dataset():
    a = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    got = preprocess.lighting(a, np.random.default_rng(5))
    np.testing.assert_array_equal(got, j_pre.lighting(a, np.random.default_rng(5)))
    with pytest.raises(ValueError, match='unknown dataset'):
        preprocess.get_transform('svhn')


def test_dataset_helpers_equal():
    samples = [(f'img{i}.png', i % 4) for i in range(11)]
    assert dataset.limit_samples(samples, 5) == j_dataset.limit_samples(samples, 5)
    assert dataset.limit_samples(samples, 50) == samples
    assert dataset.by_class(samples, [1, 3]) == j_dataset.by_class(samples, [1, 3])
    assert dataset.index_view(samples, [4, 0, 9]) == j_dataset.index_view(samples, [4, 0, 9])
    for seed in (0, 7):
        assert dataset.sample_with_replacement(samples, 9, seed) == \
            j_dataset.sample_with_replacement(samples, 9, seed)


def _npz(path, n=8, size=64, seed=0):
    rng = np.random.RandomState(seed)
    np.savez(path, images=((rng.rand(n, size, size, 3) - 0.45) / 0.22).astype(np.float32),
             labels=rng.randint(0, 1000, n))
    return str(path)


def test_cli_npz_matches_jax_cli(tmp_path, monkeypatch):
    """``--data *.npz`` with ``-sh`` (shuffled by ``RandomState(seed)``, as the
    JAX CLI does): top-1/top-5 equal, the loss within LOSS_RTOL."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        weights = write_weights(tmp_path / 'resnet18.npz')
        argv = ['-a', 'resnet18', '-b', '4', '--input_size', '64', '--device', 'cpu',
                '--weights', weights, '--data', _npz(tmp_path / 'val.npz'), '-sh',
                '--qtype', 'int4', '-qw', 'int4', '-pcq_w', '-pcq_a', '-c', 'laplace']
        out = run_both(argv, tmp_path, monkeypatch)
    finally:
        torch.set_num_threads(n)
    (j_rc, j_lines, want), (rc, lines, got) = out['jax'], out['port']
    assert j_rc == rc == 0 and want is not None and got is not None
    assert not any('using synthetic data' in ln for ln in lines + j_lines)
    assert got['top1'] == want['top1'] and got['top5'] == want['top5']
    assert abs(got['loss'] - want['loss']) <= LOSS_RTOL * abs(want['loss']), (got, want)


def test_cli_folder_route_equals_npz_route(tree, tmp_path, monkeypatch):
    """A class-folder tree decoded by ``-j 2`` threads gives the numbers of
    the same arrays handed over as an ``.npz``."""
    batches, _ = imagenet.make_loader(str(tree), 'resnet18', 7, size=32)
    images, labels = next(iter(batches))
    npz = tmp_path / 'same.npz'
    np.savez(npz, images=images, labels=labels)
    base = ['-a', 'resnet18', '-b', '3', '--input_size', '32', '--device', 'cpu',
            '--qtype', 'int8', '-qw', 'int8']
    folder = run(cli.main, base + ['--data', str(tree), '-j', '2'], tmp_path / 'a', monkeypatch)
    packed = run(cli.main, base + ['--data', str(npz)], tmp_path / 'b', monkeypatch)
    assert folder[0] == packed[0] == 0
    assert {k: folder[2][k] for k in ('top1', 'top5', 'loss')} == \
        {k: packed[2][k] for k in ('top1', 'top5', 'loss')}
