"""Capture raw tapped activations (for KLD calibration and tensor dumps).

Port of ``cnn_quantization_tpu/calib/capture.py``.  A ``CaptureContext``
records every site's pre-quantization activation of one forward: device
tensors, NCHW (the port's layout) in the producer's memory format.
"""

from __future__ import annotations

import torch

from ..engine.context import TapContext
from ..utils.device import nhwc_to_nchw


class CaptureContext(TapContext):
    mode = 'capture'

    def __init__(self):
        self.captured = {}

    def tap(self, x, site):
        self.captured[site.id] = x
        return x

    def finalize(self):
        return dict(self.captured)


def make_capture_fn(engine):
    """f(params, images NHWC) -> {site_id: activation}, on the engine's device."""

    @torch.no_grad()
    def fn(params, images):
        ctx = CaptureContext()
        x = nhwc_to_nchw(images, engine.device)
        torch.func.functional_call(engine.model, params, (x, ctx))
        return ctx.finalize()

    return fn
