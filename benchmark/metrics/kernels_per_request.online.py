"""Device kernels one request of the closed loop launches, from a traced
stretch (copies and fills not counted)."""


def read(rec):
    t = rec['trace']
    if t is None or rec['traffic']['loop'] != 'closed':
        return None
    return t['kernels'] / t['units']
