"""Where one request's time goes: named stages and spans on the served path
itself.

The path marks its stages with ``with stage("upload"):`` and its other
layers with ``with span("prep"):``. Normally both do nothing but one check
of a thread-local flag. Inside ``with record_stages() as times:`` (same
thread) they record:

- every ``stage()`` adds its host-clock milliseconds to ``times[name]``,
  and a card that is in use is synchronised at the stage's end, so device
  work is charged to the stage that enqueued it. Stages therefore serialise
  host and device: they are for measurement, and what they measure is the
  code that serves, not a copy of it;
- every ``span()`` and every ``stage()`` appends one span to the process's
  bounded buffer (``recorded_spans()``): name, request id, span id, parent
  span id, the thread's native id and its ``threading.get_ident()``, and
  its start and end on ``time.monotonic_ns()``. The outermost span on a
  thread opens a request: its request id is its own span id, and the spans
  inside it take their parent from the thread's stack. A ``span()`` never
  synchronises and never enters ``times``;
- every ``count(name, n)`` adds ``n`` to ``name`` on the innermost open
  span of the thread; when that span ends its counters go to the buffer
  (``recorded_spans()["counters"]``: name, request id, span id, total).
  A counter never synchronises: ``n`` is a Python int the caller already
  holds (a shape, a length).

A reader maps a stamp onto a ``torch.profiler`` trace's clock with the
``clock`` pair (``time.monotonic_ns()``, ``time.time_ns()``) read when
recording last started: trace µs = (stamp − mono0 + real0 −
baseTimeNanoseconds) / 1000. In such a trace a thread's host ranges carry
its native id as ``tid``, and its CUDA runtime and driver calls an id made
from its ``threading.get_ident()`` (CUPTI's thread id, pthread_self()).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional, Tuple

import torch

MAX_SPANS = 1 << 18          # spans kept; later ones are counted as dropped


class Span(NamedTuple):
    name: str
    request: int              # the root span's id
    id: int
    parent: int               # 0 for the root
    tid: int                  # threading.get_native_id()
    ident: int                # threading.get_ident()
    t0: int                   # time.monotonic_ns()
    t1: int


class _Local(threading.local):
    times: Optional[dict] = None      # the recording's stages; None: off
    stack: Optional[list] = None      # the open spans, outermost first


class Counter(NamedTuple):
    name: str
    request: int              # the root span's id
    span: int                 # the span it was counted on
    n: int                    # the total counted on that span


class _Buffer:
    def __init__(self, cap: int) -> None:
        self.cap = cap
        self.lock = threading.Lock()
        self.spans: list = []
        self.counters: list = []
        self.dropped = 0
        self.clock: Optional[Tuple[int, int]] = None

    def add(self, s: Span, counts: Optional[dict] = None) -> None:
        with self.lock:
            if len(self.spans) < self.cap:
                self.spans.append(s)
                if counts:
                    self.counters.extend(Counter(k, s.request, s.id, v)
                                         for k, v in counts.items())
            else:
                self.dropped += 1


_local = _Local()
_buffer = _Buffer(MAX_SPANS)
_ids = itertools.count(1)


class _Off:
    """The shared context of a mark while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "request", "id", "parent", "t0", "counts")

    def __init__(self, name: str) -> None:
        self.name = name
        self.counts: Optional[dict] = None

    def __enter__(self):
        stack = _local.stack
        self.id = next(_ids)
        if stack:
            self.request, self.parent = stack[-1].request, stack[-1].id
        else:
            self.request, self.parent = self.id, 0
        stack.append(self)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        _buffer.add(Span(self.name, self.request, self.id, self.parent,
                         threading.get_native_id(), threading.get_ident(),
                         self.t0, t1), self.counts)
        return False


class _Stage(_On):
    __slots__ = ("times", "p0")

    def __init__(self, name: str, times: dict) -> None:
        super().__init__(name)
        self.times = times

    def __enter__(self):
        super().__enter__()
        self.p0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times[self.name] = (self.times.get(self.name, 0.0)
                                 + (time.perf_counter() - self.p0) * 1e3)
        return super().__exit__(*exc)


def span(name: str):
    """A span of the served path: recorded only inside ``record_stages()``
    on this thread; never synchronises."""
    if _local.times is None:
        return _OFF
    return _On(name)


def stage(name: str):
    """A stage: a span that also adds its milliseconds, the card
    synchronised at its end, to the recording's ``times``."""
    times = _local.times
    if times is None:
        return _OFF
    return _Stage(name, times)


def count(name: str, n: int) -> None:
    """A counter of the served path: adds ``n`` to ``name`` on the innermost
    open span of this thread, only inside ``record_stages()`` (with no span
    open it counts nothing); never synchronises."""
    if _local.times is None:
        return
    stack = _local.stack
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n


@contextlib.contextmanager
def record_stages():
    """Collect the stages run by this thread into the dict it yields
    ({stage name: ms}, in the order the stages first ran), and its spans
    into the process's buffer."""
    times: dict = {}
    _buffer.clock = (time.monotonic_ns(), time.time_ns())
    _local.times, _local.stack = times, []
    try:
        yield times
    finally:
        _local.times, _local.stack = None, None


def recorded_spans() -> dict:
    """A copy of the buffer: {"spans": [Span], "counters": [Counter] of the
    kept spans, "dropped": spans not kept since the last clear, "clock":
    (mono0 ns, real0 ns) or None}."""
    with _buffer.lock:
        return {"spans": list(_buffer.spans),
                "counters": list(_buffer.counters),
                "dropped": _buffer.dropped, "clock": _buffer.clock}


def clear_spans() -> None:
    """Empty the buffer (spans and their counters) and its count of dropped
    spans."""
    with _buffer.lock:
        _buffer.spans.clear()
        _buffer.counters.clear()
        _buffer.dropped = 0
