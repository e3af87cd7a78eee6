"""Op/tensor monitor: record observed tensors and conv-op attributes per step.

Port of ``cnn_quantization_tpu/utils/monitor.py`` (reference utils/monitor.py:
a singleton that registers tensors, :31-34, dumps them to
``epoch_<e>_step_<s>`` files, :36-48, and records Conv2d attributes with their
input and output, :80-107).  A ``MonitorContext`` tap records every site's
tensor of one forward; op attributes are registered by the caller.  Artifacts
are ``.npz`` files with the same epoch/step naming as the JAX package's;
activations in them are NCHW, the port's layout.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..engine.context import TapContext


def to_numpy(v) -> np.ndarray:
    """A host array of a tensor on any device, or of anything array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MonitorContext(TapContext):
    """Tap context recording every site's output tensor."""

    mode = 'monitor'

    def __init__(self):
        self.observed: dict[str, Any] = {}

    def tap(self, x, site):
        self.observed[site.id] = x
        return x

    def finalize(self):
        return dict(self.observed)


class Monitor:
    """Accumulate named tensors / op records and dump one file per step."""

    def __init__(self, dump_dir: str):
        self.dump_dir = dump_dir
        os.makedirs(dump_dir, exist_ok=True)
        self.observed_tensors: dict[str, np.ndarray] = {}
        self.observed_operations: dict[str, dict[str, Any]] = {}

    def register_tensor(self, tensor, key: str):
        self.observed_tensors[key] = to_numpy(tensor)

    def register_tensors(self, tensors: dict):
        for k, v in tensors.items():
            self.register_tensor(v, k)

    def register_operation(self, key: str, attrs: dict):
        """Record one op's static attributes and tensors (the reference's
        register_Conv2d dict: in/out channels, kernel, stride, padding,
        groups, weight, input, output; utils/monitor.py:80-107)."""
        self.observed_operations[key] = {
            k: (to_numpy(v) if hasattr(v, 'shape') else v) for k, v in attrs.items()}

    def dump_tensors(self, epoch: int, step: int) -> str:
        path = os.path.join(self.dump_dir, f'epoch_{epoch}_step_{step}.npz')
        np.savez_compressed(path, **self.observed_tensors)
        self.observed_tensors.clear()
        return path

    def dump_operations(self, epoch: int, step: int) -> str:
        path = os.path.join(self.dump_dir, f'epoch_{epoch}_step_{step}_ops.npz')
        flat = {f'{op}|{k}': np.asarray(v)
                for op, attrs in self.observed_operations.items() for k, v in attrs.items()}
        np.savez_compressed(path, **flat)
        self.observed_operations.clear()
        return path

    def clear_tensors(self):
        self.observed_tensors.clear()

    def clear_operations(self):
        self.observed_operations.clear()


@torch.no_grad()
def monitor_forward(engine, params, images) -> dict[str, np.ndarray]:
    """One forward on the engine's device; every site's output tensor on the
    host (NCHW)."""
    from .device import nhwc_to_nchw
    ctx = MonitorContext()
    torch.func.functional_call(engine.model, params, (nhwc_to_nchw(images, engine.device), ctx))
    return {k: to_numpy(v) for k, v in ctx.finalize().items()}
