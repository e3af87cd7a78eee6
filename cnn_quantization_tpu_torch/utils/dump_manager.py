"""Tensor dump debugging utility.

Port of ``cnn_quantization_tpu/utils/dump_manager.py`` (reference
utils/dump_manager.py): named tensors as ``.npy`` files under a tagged
directory, driven by the CLI's ``--dump_dir``.  One forward captures every
tapped activation; the files are written on the host.  Activations are
dumped NCHW, the port's layout (the JAX package dumps NHWC).
"""

from __future__ import annotations

import os

import numpy as np

from .monitor import to_numpy


class DumpManager:
    def __init__(self, dump_dir: str, tag: str = ''):
        self.dump_dir = dump_dir
        self.tag = tag

    def set_tag(self, tag: str):
        self.tag = tag

    def dump(self, tensor, name: str):
        d = os.path.join(self.dump_dir, self.tag) if self.tag else self.dump_dir
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f'{name}.npy'), to_numpy(tensor))

    def dump_all(self, tensors: dict):
        for name, t in tensors.items():
            self.dump(t, name)


def dump_activations(engine, params, images, dump_dir: str, tag: str = 'batch0'):
    """Capture every tapped activation of one batch and write ``.npy`` files
    (the reference's --dump_dir flow, inference_sim.py:287-312); returns the
    sorted site ids."""
    from ..calib.capture import make_capture_fn

    acts = make_capture_fn(engine)(params, images)
    DumpManager(dump_dir, tag).dump_all(acts)
    return sorted(acts)
