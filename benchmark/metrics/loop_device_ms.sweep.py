"""``evaluate``'s own time per batch (ms): its CUDA events around each
step, summed, as its ``images_per_sec`` counts them; the gaps between steps
are left out."""


def read(rec):
    if rec['traffic']['loop'] != 'sweep':
        return None
    return 1e3 * rec['traffic']['batch'] / rec['window']['result']['images_per_sec']
