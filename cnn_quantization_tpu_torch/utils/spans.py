"""Spans at the port's layer boundaries, kept in host memory.

A span records its name, its start and end on ``time.perf_counter_ns()``, the
span it was opened inside, the id of the batch or request it belongs to (its
parent's, or its own sequence number for a span opened at the top), and a few
integer counts.  There are two levels:

* coarse spans are always kept: the eval loop's batch and its wait on the
  batch iterator, each forward, the copy of its images to the device, the
  meters, and the preparation's phases (the kernels' load, the weight pass,
  the calibration, the freezes).  A few a batch, each a microsecond or two;
* fine spans, ``layer.<Class>``, one per forward of a module of
  ``models/layers.py`` and of the blocks, are kept only while a torch profiler
  is active (``traced``).  While none is, a module call pays one flag test.

While a profiler is active every span is also entered as a
``torch._C._profiler._RecordFunctionFast`` of its name, so it lands in the
profiler's host timeline as a ``cpu_op`` beside the device's kernels (and in
``utils/profiling.trace``'s Chrome trace).  ``torch.profiler.record_function``
is not used: its ``user_annotation`` ranges come with ``gpu_user_annotation``
ranges on the device's timeline, which a reader of that timeline would count
as device work.

The records live in a ring of ``CAPACITY`` spans (``Recorder``); the oldest
are overwritten first.  ``snapshot()`` returns them with ``held_from_ns``, a
stamp from which every span that began is held, so that a reader can refuse a
stretch it no longer holds whole.  ``anchor`` pairs ``time.time_ns()`` with
``perf_counter_ns()``, taken together, to put a span on the profiler's clock
(kineto's event times are Unix-epoch ns): ``to_unix_ns``.

A span never synchronises the device, never allocates device memory and
formats no string: names are constants.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

# a 51 s window of the closed loop (about 5,000 requests of 2 spans), a traced
# stretch of 100 requests of some 80 spans each, and the set-up, with room
# for a host three times as fast
CAPACITY = 1 << 17

_now = time.perf_counter_ns


class SpanRecord(NamedTuple):
    """One span as ``snapshot`` returns it; ``end_ns`` is None while open."""
    seq: int
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    batch: int
    counts: dict | None


class Span:
    """An open or closed span; a context manager.  Set ``counts`` (a dict of
    integers) before it closes to carry counts."""

    __slots__ = ('_recorder', 'name', 'batch', 'counts', 'seq', 'parent', 'start_ns',
                 'end_ns', '_rf')

    def __init__(self, recorder: Recorder, name: str, batch: int | None = None,
                 counts: dict | None = None):
        self._recorder, self.name, self.batch, self.counts = recorder, name, batch, counts
        self.end_ns = self._rf = None

    def __enter__(self) -> Span:
        rec = self._recorder
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.seq = seq = next(rec._seq)
        self.parent = None if top is None else top.seq
        if self.batch is None:
            self.batch = seq if top is None else top.batch
        rec._put(seq, self)
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.start_ns = _now()
        return self

    def __exit__(self, *exc):
        self.end_ns = _now()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._recorder._stack().pop()
        return False


class Recorder:
    """A bounded ring of spans (``capacity``, a power of two), one nesting
    stack per thread."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f'capacity must be a power of two, got {capacity}')
        self.capacity, self._mask = capacity, capacity - 1
        self._ring: list = [None] * capacity
        self._seq = itertools.count()
        self._lost_ns = -1      # the latest start of an overwritten span
        self._local = threading.local()
        self.anchor = (time.time_ns(), _now())

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, batch: int | None = None, counts: dict | None = None) -> Span:
        """A span ``name``, to be entered with ``with``; ``batch`` defaults
        to the enclosing span's id (or the span's own sequence number)."""
        return Span(self, name, batch, counts)

    def add(self, name: str, start_ns: int, end_ns: int, parent: Span | None = None,
            counts: dict | None = None):
        """A closed span timed elsewhere (another thread), under ``parent``."""
        s = Span(self, name, None if parent is None else parent.batch, counts)
        s.seq = seq = next(self._seq)
        s.parent = None if parent is None else parent.seq
        if s.batch is None:
            s.batch = seq
        s.start_ns, s.end_ns = start_ns, end_ns
        self._put(seq, s)

    def _put(self, seq: int, s: Span):
        i = seq & self._mask
        old = self._ring[i]
        if old is not None and old.start_ns > self._lost_ns:
            self._lost_ns = old.start_ns
        self._ring[i] = s

    def snapshot(self) -> dict:
        """{'spans': every held span as a ``SpanRecord``, in the order they
        were opened; 'held_from_ns': 0 if none was overwritten, else a stamp
        from which every span that began is held; 'anchor', 'capacity'}."""
        held = sorted((s for s in self._ring if s is not None), key=lambda s: s.seq)
        spans = [SpanRecord(s.seq, s.name, s.start_ns, s.end_ns, s.parent, s.batch,
                            None if s.counts is None else dict(s.counts)) for s in held]
        return {'spans': spans, 'held_from_ns': self._lost_ns + 1, 'anchor': self.anchor,
                'capacity': self.capacity}


RECORDER = Recorder()
# the process's recorder, which the port's spans go to
span, add, snapshot = RECORDER.span, RECORDER.add, RECORDER.snapshot


def to_unix_ns(t_ns: int) -> int:
    """A ``perf_counter_ns`` stamp on the Unix-epoch clock of the profiler's
    events, by the recorder's anchor pair."""
    unix, perf = RECORDER.anchor
    return t_ns - perf + unix


def traced(name: str):
    """Decorate a module's ``forward``: a fine span ``name`` around each call
    while a torch profiler is active, and nothing but the flag test else."""
    def wrap(forward):
        @functools.wraps(forward)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return forward(*args, **kwargs)
            with Span(RECORDER, name):
                return forward(*args, **kwargs)
        return call
    return wrap
