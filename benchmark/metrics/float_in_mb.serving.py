"""MB a batch of floating activations that the integer convs and linears of
the serving sweep take in and quantize themselves before their kernels (the
program's ``int8_conv.float_in_bytes`` and ``int8_gemm.float_in_bytes`` counts
of each forward in the window, their median): the float hand-off between
layers, which int8 codes handed from kernel to kernel do away with."""

from benchmark import count_reads


def read(rec):
    t = rec['traffic']
    if t['path'] != 'serving' or t['loop'] != 'sweep':
        return None
    return count_reads.forward_mb(rec, ('int8_conv.float_in_bytes', 'int8_gemm.float_in_bytes'))
