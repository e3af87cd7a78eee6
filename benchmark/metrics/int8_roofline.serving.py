"""The integer kernels' share of their roofline on the serving sweep (%):
the least time of every integer conv and linear of a batch (the larger of
2 x MACs at 1,979 TOP/s and int8 codes in, int8 weights and the output as the
next layer needs it at 3.35 TB/s; ``yardstick.work``) over the device time of
the int8 GEMM and conv classes per batch, from a traced stretch."""


def read(rec):
    t = rec['trace']
    if t is None or rec['traffic']['path'] != 'serving' or rec['traffic']['loop'] != 'sweep':
        return None
    busy = (t['class_s'].get('int8_gemm', 0.0) + t['class_s'].get('int8_conv', 0.0)) / t['units']
    return 100.0 * rec['work']['int8_bound_s'] / busy if busy > 0 else None
