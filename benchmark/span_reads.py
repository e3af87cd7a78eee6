"""The program's own spans (``cnn_quantization_tpu_torch.utils.spans``) as
the span readers of ``metrics/`` need them: those the measured window opened,
and those the set-up before it closed.

The window runs from ``window['stamps'][0]`` for ``window['seconds']``; the
set-up is everything before it.  Each function returns None where the program
records no spans (a version without the recorder), or where its ring no longer
holds the stretch whole: a reader gives no number rather than a partial one.
"""

from __future__ import annotations


def snapshot():
    """The program's spans, or None where it records none."""
    try:
        from cnn_quantization_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.snapshot()


def _window_ns(rec):
    w = rec['window']
    t0 = int(w['stamps'][0] * 1e9)
    return t0, t0 + int(w['seconds'] * 1e9)


def window(rec):
    """The spans opened inside the window, or None."""
    snap = snapshot()
    if snap is None or not rec['window'].get('stamps'):
        return None
    t0, t1 = _window_ns(rec)
    if snap['held_from_ns'] > t0:
        return None
    return [s for s in snap['spans'] if t0 <= s.start_ns <= t1]


def setup(rec):
    """The spans closed before the window, or None."""
    snap = snapshot()
    if snap is None or not rec['window'].get('stamps') or snap['held_from_ns'] > 0:
        return None
    t0, _ = _window_ns(rec)
    return [s for s in snap['spans'] if s.end_ns is not None and s.end_ns <= t0]


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) / 1e9


def forward_host_s(spans) -> list | None:
    """Host seconds of each forward (``engine.forward``) less its copy of
    the images to the device (``device.h2d``), or None without one."""
    if spans is None:
        return None
    copies = {}
    for s in spans:
        if s.name == 'device.h2d' and s.end_ns is not None:
            copies[s.parent] = copies.get(s.parent, 0.0) + seconds(s)
    out = [seconds(s) - copies.get(s.seq, 0.0) for s in spans
           if s.name == 'engine.forward' and s.end_ns is not None]
    return out or None


def total_s(spans, names) -> float | None:
    """Summed seconds of the spans named in ``names``, or None without one."""
    if spans is None:
        return None
    picked = [seconds(s) for s in spans if s.name in names]
    return sum(picked) if picked else None
