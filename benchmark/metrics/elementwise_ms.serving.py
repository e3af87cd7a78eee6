"""Device ms per batch in PyTorch's elementwise kernels on the serving
sweep: the quantize, requantize, ReLU, residual and pooling passes around
the integer kernels, from a traced stretch."""


def read(rec):
    t = rec['trace']
    if t is None or rec['traffic']['path'] != 'serving' or rec['traffic']['loop'] != 'sweep':
        return None
    return 1e3 * t['class_s'].get('elementwise', 0.0) / t['units']
