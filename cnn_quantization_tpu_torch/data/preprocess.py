"""Composable image transform builders (numpy, NHWC).

Port of ``cnn_quantization_tpu/data/preprocess.py`` (reference
utils/preprocess.py): torchvision-transform builders with the ImageNet
mean/std and PCA-lighting constants (:5-16), scale/center-crop (:19-28),
pad-random-crop (:43-50), inception random-resized-crop (:52-58), PCA
Lighting noise (:108-...) and a dataset-keyed ``get_transform`` (:74-105).
Host code, numpy + PIL as in the JAX package, so a transform gives the same
array bit for bit from the same image and generator; the CLI moves batches
to the device.

Each builder returns ``fn(PIL.Image | np.ndarray[H,W,C] uint8, rng=None) ->
np.ndarray[H,W,C] float32`` (normalized).  Randomness is explicit: an
``np.random.Generator`` argument, never global state.
"""

from __future__ import annotations

import numpy as np

from .imagenet import require_pil

IMAGENET_STATS = {'mean': np.array([0.485, 0.456, 0.406], np.float32),
                  'std': np.array([0.229, 0.224, 0.225], np.float32)}

# AlexNet-style PCA lighting basis (reference utils/preprocess.py:8-16).
IMAGENET_PCA = {
    'eigval': np.array([0.2175, 0.0188, 0.0045], np.float32),
    'eigvec': np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32),
}


def _to_array(img) -> np.ndarray:
    if isinstance(img, np.ndarray):
        a = img
    else:  # PIL image
        a = np.asarray(img.convert('RGB') if img.mode != 'RGB' else img)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    return a.astype(np.float32)


def _resize_shorter(a: np.ndarray, size: int) -> np.ndarray:
    Image = require_pil()
    h, w = a.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    im = Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8))
    return np.asarray(im.resize((nw, nh), Image.BILINEAR), np.float32) / 255.0


def normalize(a: np.ndarray, stats=None) -> np.ndarray:
    stats = stats or IMAGENET_STATS
    return (a - np.asarray(stats['mean'], np.float32)) / \
        np.asarray(stats['std'], np.float32)


def lighting(a: np.ndarray, rng: np.random.Generator,
             alphastd: float = 0.1, pca=None) -> np.ndarray:
    """PCA color-noise augmentation (reference Lighting class)."""
    pca = pca or IMAGENET_PCA
    alpha = rng.normal(0.0, alphastd, size=3).astype(np.float32)
    shift = (pca['eigvec'] * alpha * pca['eigval']).sum(axis=1)
    return a + shift


def _center_crop(a, size):
    h, w = a.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return a[top:top + size, left:left + size]


def scale_crop(input_size: int, scale_size: int | None = None, stats=None):
    """Resize shorter side then center-crop (eval transform,
    reference preprocess.py:19-28)."""
    def fn(img, rng=None):
        a = _to_array(img)
        if scale_size and scale_size != input_size:
            a = _resize_shorter(a, scale_size)
        return normalize(_center_crop(a, input_size), stats)
    return fn


def scale_random_crop(input_size: int, scale_size: int | None = None,
                      stats=None):
    """Resize then random-crop (reference preprocess.py:30-40)."""
    def fn(img, rng=None):
        rng = rng or np.random.default_rng()
        a = _to_array(img)
        if scale_size and scale_size != input_size:
            a = _resize_shorter(a, scale_size)
        h, w = a.shape[:2]
        top = int(rng.integers(0, h - input_size + 1))
        left = int(rng.integers(0, w - input_size + 1))
        return normalize(a[top:top + input_size, left:left + input_size], stats)
    return fn


def pad_random_crop(input_size: int, scale_size: int, stats=None):
    """Zero-pad then random-crop + horizontal flip
    (reference preprocess.py:43-50, CIFAR style)."""
    padding = (scale_size - input_size) // 2

    def fn(img, rng=None):
        rng = rng or np.random.default_rng()
        a = _to_array(img)
        a = np.pad(a, ((padding, padding), (padding, padding), (0, 0)))
        h, w = a.shape[:2]
        top = int(rng.integers(0, h - input_size + 1))
        left = int(rng.integers(0, w - input_size + 1))
        a = a[top:top + input_size, left:left + input_size]
        if rng.random() < 0.5:
            a = a[:, ::-1]
        return normalize(np.ascontiguousarray(a), stats)
    return fn


def inception_preprocess(input_size: int, stats=None, color: bool = False):
    """Random-resized-crop + flip (+ PCA lighting when ``color``)
    (reference preprocess.py:52-71)."""
    def fn(img, rng=None):
        rng = rng or np.random.default_rng()
        a = _to_array(img)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = float(rng.uniform(0.08, 1.0)) * area
            ar = float(np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3))))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                a = a[top:top + ch, left:left + cw]
                break
        else:
            a = _center_crop(_resize_shorter(a, input_size), input_size)
        Image = require_pil()
        im = Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8))
        a = np.asarray(im.resize((input_size, input_size), Image.BILINEAR),
                       np.float32) / 255.0
        if rng.random() < 0.5:
            a = np.ascontiguousarray(a[:, ::-1])
        if color:
            a = lighting(a, rng)
        return normalize(a, stats)
    return fn


def get_transform(name: str = 'imagenet', input_size: int | None = None,
                  scale_size: int | None = None, stats=None,
                  augment: bool = True):
    """Dataset-keyed transform factory (reference preprocess.py:74-105)."""
    if name == 'imagenet':
        input_size = input_size or 224
        scale_size = scale_size or 256
        if augment:
            return inception_preprocess(input_size, stats=stats)
        return scale_crop(input_size, scale_size, stats)
    if 'cifar' in name:
        input_size = input_size or 32
        if augment:
            return pad_random_crop(input_size, scale_size or 40, stats)
        return scale_crop(input_size, scale_size or 32, stats)
    if name == 'mnist':
        stats = stats or {'mean': np.array([0.5], np.float32),
                          'std': np.array([0.5], np.float32)}
        input_size = input_size or 28
        if augment:
            return pad_random_crop(input_size, scale_size or 32, stats)
        return scale_crop(input_size, scale_size or 32, stats)
    raise ValueError(f'unknown dataset: {name}')
