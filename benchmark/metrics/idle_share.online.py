"""The device's idle share of the closed loop (%): 1 - the union of its operations'
intervals in a traced stretch over the time the same number of
requests took in the untraced window, so that the profiler's own host cost
is not counted as idle."""


def read(rec):
    t = rec['trace']
    if t is None or rec['traffic']['loop'] != 'closed':
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['untraced_s'])
