"""The benchmark's metric arithmetic, frozen here so that no later change
to the program can move the yardstick.

- ``percentile``: nearest-rank percentile over every sample (the tail of
  all requests, not a median of chunks);
- ``median``;
- ``union_length``: the device's busy time as the union of its
  operations' intervals (kernels and copies overlap on several streams).
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank p-th percentile (0 < p ≤ 100): the smallest value with
    at least p% of the samples at or below it. Written for this benchmark
    after bench/http.py ``_pct``, which indexes int(n·p) and so reads one
    rank high."""
    if not values:
        raise ValueError("percentile of no samples")
    s = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return float(s[rank - 1])


def median(values: Sequence[float]) -> float:
    """The median of every sample (statistics.median, as the driver reads
    its runs)."""
    return float(statistics.median(values))


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by [start, end) intervals (written for this
    benchmark; bench/ and chip_smoke.py summed kernel times, which counts
    overlapping streams twice)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total
