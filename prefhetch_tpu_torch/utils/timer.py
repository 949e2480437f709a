"""Wall-clock timing utilities.

Parity with the reference's ``Timer`` (reference:
include/common/client_server_utils.h:58-67,
src/common/client_server_utils.cpp:3-24): start/stop, duration in both
microseconds and milliseconds. Extended with named-stage accumulation, which
the reference lacked (its single timer wrapped client stages 1-7 only,
src/client/client.cpp:9-66).

Copy of prefhetch_tpu/utils/timer.py.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple


class Timer:
    """Start/stop wall-clock timer reporting (microseconds, milliseconds)."""

    def __init__(self) -> None:
        self._start: float = 0.0
        self._end: float = 0.0

    def start_timer(self) -> None:
        self._start = time.perf_counter()

    def stop_timer(self) -> None:
        self._end = time.perf_counter()

    def get_duration(self) -> Tuple[int, int]:
        """Return (micros, millis) of the last start→stop interval."""
        delta = self._end - self._start
        return int(delta * 1e6), int(delta * 1e3)


class StageTimer:
    """Accumulates named stage durations (seconds). New capability."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    class _Ctx:
        def __init__(self, outer: "StageTimer", name: str) -> None:
            self.outer, self.name = outer, name

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.outer.stages[self.name] = (
                self.outer.stages.get(self.name, 0.0)
                + time.perf_counter() - self._t0
            )
            return False

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def total(self) -> float:
        return sum(self.stages.values())
