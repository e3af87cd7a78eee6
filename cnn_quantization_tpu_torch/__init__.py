"""cnn_quantization_tpu_torch — the PyTorch/CUDA port of cnn_quantization_tpu.

The JAX package beside it is the reference this port is held against.  The
module tree mirrors it (``ops/``, ``ops/kernels/``, ``engine/``, ``models/``,
``calib/``, ``data/``, ``utils/``, ``cli/``) so each module's counterpart is
found by name.  Inside, the port is idiomatic PyTorch: ``nn.Module`` models,
plain functions on tensors for the ops, an explicit ``device`` and explicit
``torch.Generator`` objects.

Layout: activations are logical NCHW in the ``torch.channels_last`` memory
format (the channel axis is stride-1, the layout the Pallas kernel assumed);
conv weights are OIHW.  Images arrive NHWC at the public boundaries, exactly
as ``data/synthetic.py`` yields them.

The fake-quant that runs at every quantization site is a CUDA kernel written
by hand for sm_90a (``csrc/fake_quant.cu``), built from source at first use.
Entry points run on the card unless the caller passes ``device='cpu'``.
"""

__version__ = "0.1.0"
