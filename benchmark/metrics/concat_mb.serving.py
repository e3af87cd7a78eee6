"""MB a batch that the mixed blocks' channel concatenations write on the
serving sweep (the program's ``concat.bytes`` count of each forward in the
window, their median)."""

from benchmark import count_reads


def read(rec):
    t = rec['traffic']
    if t['path'] != 'serving' or t['loop'] != 'sweep':
        return None
    return count_reads.forward_mb(rec, ('concat.bytes',))
