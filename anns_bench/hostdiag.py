"""Readings of the host around a run, for finding what moves its numbers.

Every run writes ``.scratch/host.<cell>.<seed>.t<trace>.json`` and prints
nothing of it: set-up split into its parts by the harness's own
timestamps (``mark``, and ``part`` for the client's work inside one mark),
a fixed pure-Python probe just before and just after the window, the
process's ``getrusage(RUSAGE_SELF)`` as the window opens and once it has
closed (user and system CPU), and each client thread's CPU time over the
window (``time.thread_time``). The card's host exposes no scheduler
statistics, per-CPU counters or cgroup ``cpu.stat`` to a process, so none
are read. Everything here only reads; it sets nothing.
"""

from __future__ import annotations

import contextlib
import json
import resource
import time
from typing import Dict, List, Optional

PROBE_LOOPS = 400_000


def probe_s() -> float:
    """Seconds a fixed pure-Python loop takes (30-57 ms on the card's
    host): the host's single-thread speed at that moment."""
    t = time.perf_counter()
    acc = 0
    for i in range(PROBE_LOOPS):
        acc += i * i & 7
    return time.perf_counter() - t


class Host:
    """Set-up marks, probes and window readings of one run."""

    def __init__(self, t_start: float):
        self.marks: List[list] = [["start", t_start]]
        self.parts: Dict[str, float] = {}
        self.probes: Dict[str, float] = {}
        self.window: Dict[str, dict] = {}
        self.threads: Dict[str, list] = {}

    def mark(self, name: str, t: Optional[float] = None) -> None:
        """The set-up part ``name`` ended now (or at ``t``)."""
        self.marks.append([name, time.monotonic() if t is None else t])

    @contextlib.contextmanager
    def part(self, name: str):
        """Seconds spent inside, summed by name (parts of one mark)."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = (self.parts.get(name, 0.0)
                                + time.perf_counter() - t)

    def probe(self, name: str) -> None:
        self.probes[name] = probe_s()

    def snap(self, name: str) -> None:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.window[name] = {"t": time.monotonic(), "utime": ru.ru_utime,
                             "stime": ru.ru_stime}

    def write(self, path: str, extra: dict) -> None:
        marks = self.marks
        setup = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
        out = dict(extra, setup_parts=setup, client_parts=self.parts,
                   probes=self.probes, window=self.window,
                   thread_time=self.threads)
        with open(path, "w") as f:
            json.dump(out, f)
