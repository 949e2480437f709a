"""Where one request's time goes: named stages on the served path itself.

The path marks its stages with ``with stage("upload"):``. Normally that does
nothing. Inside ``with record_stages() as times:`` (same thread) each stage
adds its host-clock milliseconds to ``times[name]``, and a card that is in
use is synchronised at the stage's end, so device work is charged to the
stage that enqueued it. Recording therefore serialises host and device: it
is for measurement, and what it measures is the code that serves, not a copy
of it.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_local = threading.local()


@contextlib.contextmanager
def stage(name: str):
    times = getattr(_local, "times", None)
    if times is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def record_stages():
    """Collect the stages run by this thread into the dict it yields
    ({stage name: ms}, in the order the stages first ran)."""
    times: dict = {}
    _local.times = times
    try:
        yield times
    finally:
        _local.times = None
