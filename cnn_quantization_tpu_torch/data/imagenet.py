"""ImageNet validation input pipeline: a class-folder tree or a preprocessed
``.npz``.

Port of ``cnn_quantization_tpu/data/imagenet.py`` (reference
inference/inference_sim.py:209-229, the torchvision DataLoader stack): resize
the shorter side to 256 (299 for inception), center-crop 224 (299), scale to
[0, 1], normalize with the ImageNet mean/std; bilinear resize, torchvision's
default.  Host code, numpy + PIL as in the JAX package, so the batches are
the same arrays bit for bit: NHWC float32 numpy, which the CLI moves to the
device (``utils/device.nhwc_to_nchw``).

Decode and preprocess run in a thread pool of ``workers`` threads (the
reference's DataLoader workers, ``-j``) with double-buffered prefetch.  A
machine without PIL cannot decode a class-folder tree: that route raises,
naming PIL and the ``.npz`` route, which needs no decoder.
"""

from __future__ import annotations

import os
import queue
from typing import Iterator

import numpy as np

from .synthetic import IMAGENET_MEAN, IMAGENET_STD

IMAGE_SUFFIXES = ('.jpeg', '.jpg', '.png', '.bmp')


def find_samples(valdir: str):
    """(path, label) list; labels = sorted class-dir index (ImageFolder rule)."""
    classes = sorted(d for d in os.listdir(valdir)
                     if os.path.isdir(os.path.join(valdir, d)))
    samples = []
    for idx, cls in enumerate(classes):
        d = os.path.join(valdir, cls)
        for fn in sorted(os.listdir(d)):
            if fn.lower().endswith(IMAGE_SUFFIXES):
                samples.append((os.path.join(d, fn), idx))
    return samples


def require_pil():
    """PIL's ``Image`` module, or an ImportError that says what to do
    without it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError('decoding a class-folder image tree needs PIL (Pillow), which is '
                          'not installed; preprocess the images into an .npz (arrays '
                          "'images' [N,H,W,3] float32 and 'labels' [N]) and pass that "
                          'file as --data instead') from e
    return Image


def _load_image(path: str, resize: int, crop: int) -> np.ndarray:
    Image = require_pil()
    with Image.open(path) as im:
        im = im.convert('RGB')
        w, h = im.size
        if w < h:
            nw, nh = resize, int(round(h * resize / w))
        else:
            nw, nh = int(round(w * resize / h)), resize
        im = im.resize((nw, nh), Image.BILINEAR)
        left = (nw - crop) // 2
        top = (nh - crop) // 2
        im = im.crop((left, top, left + crop, top + crop))
        arr = np.asarray(im, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class ImageNetVal:
    """Batches of a class-folder tree: ``(images [B,crop,crop,3] float32,
    labels [B] int32)``, decoded by ``workers`` threads two batches ahead."""

    def __init__(self, valdir: str, batch_size: int, *, resize: int = 256,
                 crop: int = 224, shuffle: bool = False, seed: int = 12345,
                 workers: int = 8, limit: int | None = None):
        require_pil()
        self.samples = find_samples(valdir)
        if shuffle:
            rng = np.random.RandomState(seed)
            rng.shuffle(self.samples)
        if limit is not None:
            self.samples = self.samples[:limit]
        self.batch_size = batch_size
        self.resize = resize
        self.crop = crop
        self.workers = max(1, workers)

    def __len__(self):
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, batch):
        imgs = np.stack([_load_image(p, self.resize, self.crop) for p, _ in batch])
        labels = np.array([label for _, label in batch], np.int32)
        return imgs, labels

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor
        bs = self.batch_size
        batches = iter([self.samples[i:i + bs] for i in range(0, len(self.samples), bs)])
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = queue.Queue()   # double-buffered prefetch
            for _ in range(2):
                b = next(batches, None)
                if b is not None:
                    futures.put(pool.submit(self._make_batch, b))
            while not futures.empty():
                f = futures.get()
                b = next(batches, None)
                if b is not None:
                    futures.put(pool.submit(self._make_batch, b))
                yield f.result()


def load_npz_batches(path: str, batch_size: int, *, shuffle: bool = False,
                     limit: int | None = None, seed: int = 12345):
    """The preprocessed ``.npz`` eval set (arrays ``images`` [N,H,W,3]
    float32, already normalized, and ``labels`` [N]) cut into batches."""
    with np.load(path) as z:
        images = np.asarray(z['images'], np.float32)
        labels = np.asarray(z['labels'], np.int32)
    if shuffle:
        perm = np.random.RandomState(seed).permutation(len(images))
        images, labels = images[perm], labels[perm]
    if limit is not None:
        images, labels = images[:limit], labels[:limit]
    return [(images[i:i + batch_size], labels[i:i + batch_size])
            for i in range(0, len(images), batch_size)]


def make_loader(data_dir: str | None, arch: str, batch_size: int, *,
                shuffle: bool = False, limit: int | None = None,
                synthetic_batches_count: int = 8, seed: int = 12345,
                size: int | None = None, workers: int = 8):
    """(batches, real_data): the ``.npz`` eval set if ``data_dir`` is one,
    else the class-folder tree at ``data_dir/val`` or ``data_dir``, else the
    synthetic fallback (``synthetic_batches_count`` batches, or
    ``limit // batch_size``), exactly as the JAX package's ``make_loader``.
    ``size`` overrides the arch's crop (224, 299 for inception_v3);
    ``workers`` is the decode pool's size (class-folder route only)."""
    if size is None:
        size = 299 if arch == 'inception_v3' else 224
    resize = max(size + 32, size * 256 // 224)
    if data_dir and data_dir.endswith('.npz') and os.path.exists(data_dir):
        return load_npz_batches(data_dir, batch_size, shuffle=shuffle, limit=limit,
                                seed=seed), True
    valdir = None
    if data_dir:
        cand = os.path.join(data_dir, 'val')
        valdir = cand if os.path.isdir(cand) else (data_dir if os.path.isdir(data_dir) else None)
    if valdir and find_samples(valdir):
        return ImageNetVal(valdir, batch_size, resize=resize, crop=size, shuffle=shuffle,
                           limit=limit, seed=seed, workers=workers), True
    from .synthetic import synthetic_batches
    n = synthetic_batches_count if limit is None else max(1, limit // batch_size)
    return list(synthetic_batches(batch_size, n, size=size, seed=seed)), False
