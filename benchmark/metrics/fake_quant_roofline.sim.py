"""The fake-quant kernel's share of its roofline on the simulation sweep
(%): every quantization site's tensor read and written once in float32 at
3.35 TB/s (``yardstick.work``) over the fake-quant class's device time per
batch, from a traced stretch."""


def read(rec):
    t = rec['trace']
    if t is None or rec['traffic']['path'] != 'sim':
        return None
    busy = t['class_s'].get('fake_quant', 0.0) / t['units']
    return 100.0 * rec['work']['fake_quant_bound_s'] / busy if busy > 0 else None
