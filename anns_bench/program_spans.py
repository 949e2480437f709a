"""The program's own spans in a traced run, mapped onto the profiled slice.

The program records a span tree per request inside ``record_stages()``
(``prefhetch_tpu_torch/utils/stages.py``), which the traced run enters
around every request of the window (``Tracer.request``). This module
fetches that buffer once per run and, where the run profiled a slice, maps
each span onto the slice trace's clock (``tracing.device_slice`` writes
``.scratch/slice_trace.json``): trace µs = (stamp − mono0 + real0 −
baseTimeNanoseconds) / 1000, with the (monotonic, real) clock pair the
program read when recording started.

What the readers in ``metrics/`` take from it:

- ``median``: a value a request over the window's requests of one route;
- ``launches``: the runtime and driver calls that enqueued a device
  operation (their correlation id has one in the slice), made on the
  span's thread inside the named span, a request, over the requests that
  lie wholly inside the slice;
- ``idle_in_program_pct``: the device's idle share (the slice's
  ``busy_s``/``window_s``, as ``device.idle_pct.*``) times the share of the
  slice's idle time that lies inside a root span, so never above it; the
  whole attribution (idle ms by innermost open span, and "outside") goes
  to ``.scratch/idle_by_span.<cell>.json``.

A program without the recorder, a run without requests or a run without a
slice reads nothing (None), never 0.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from anns_bench import stats
from anns_bench.cell import SCRATCH
from anns_bench.tracing import GPU_CATS

CALL_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"


def cupti_tid(v: int) -> int:
    """A thread id as a slice trace writes it for CUDA runtime and driver
    calls: the low 32 bits of pthread_self() read as a signed int32, with
    its sign dropped (seen on the H100 with torch 2.11: 0xf33ff6c0 written
    as 0x0cc00940). Idempotent, so it normalises both sides."""
    v &= 0xFFFFFFFF
    return abs(v - (1 << 32) if v >= 1 << 31 else v)


def thread_of(span) -> int:
    """The slice's ``tid`` for the CUDA calls of the span's thread (its
    ``threading.get_ident()`` is pthread_self(); host ranges carry the
    native id instead)."""
    return cupti_tid(span.ident)


def _fetch() -> Optional[dict]:
    """The program's buffer, or None when the program has no recorder."""
    from prefhetch_tpu_torch.utils import stages

    get = getattr(stages, "recorded_spans", None)
    return get() if get is not None else None


class Request:
    """One request's spans: its root and every span under it."""

    def __init__(self, root, spans: list):
        self.root, self.spans = root, spans

    def ms(self, name: str) -> Optional[float]:
        """Total ms of the request's spans called ``name`` (None if none)."""
        d = [s.t1 - s.t0 for s in self.spans if s.name == name]
        return sum(d) / 1e6 if d else None

    def self_ms(self, span, child: str) -> Optional[float]:
        """``span``'s ms minus its direct children called ``child``."""
        kids = [s for s in self.spans if s.parent == span.id
                and s.name == child]
        if not kids:
            return None
        return (span.t1 - span.t0 - sum(s.t1 - s.t0 for s in kids)) / 1e6

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


class Slice:
    """The profiled slice's device operations and enqueuing calls, in trace
    µs, and the map of the program's stamps onto that clock."""

    def __init__(self, trace: dict, clock: Tuple[int, int]):
        ev = trace["traceEvents"]
        self.base = int(trace.get("baseTimeNanoseconds", 0))
        self.mono0, self.real0 = clock
        ops, corr = [], set()
        for e in ev:
            if e.get("cat") in GPU_CATS:
                ops.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
                corr.add(e.get("args", {}).get("correlation"))
        corr.discard(None)
        calls: Dict[int, List[float]] = collections.defaultdict(list)
        for e in ev:
            if (e.get("cat") in CALL_CATS
                    and e.get("args", {}).get("correlation") in corr):
                calls[cupti_tid(int(e.get("tid", 0)))].append(
                    float(e["ts"]))
        self.calls = {t: sorted(v) for t, v in calls.items()}
        ends = [t for a, b in ops for t in (a, b)]
        ends += [t for v in self.calls.values() for t in v]
        self.h = (min(ends), max(ends)) if ends else None
        self.busy = _merge(ops)

    def us(self, stamp_ns: int) -> float:
        return (stamp_ns - self.mono0 + self.real0 - self.base) / 1e3

    def interval(self, span) -> Tuple[float, float]:
        return self.us(span.t0), self.us(span.t1)

    def count_calls(self, span) -> int:
        """The enqueuing calls of the span's thread inside the span."""
        a, b = self.interval(span)
        v = self.calls.get(thread_of(span), [])
        return bisect.bisect_right(v, b) - bisect.bisect_left(v, a)

    def inside(self, span) -> bool:
        a, b = self.interval(span)
        return self.h is not None and self.h[0] <= a and b <= self.h[1]


class Program(NamedTuple):
    requests: List[Request]      # the window's, by start
    slice: Optional[Slice]
    dropped: int                 # spans the program's buffer did not keep


def load(run) -> Optional[Program]:
    """The run's program spans, fetched and mapped once (kept on ``run``)."""
    if "_program_spans" not in vars(run):
        run._program_spans = _load(run)
    return run._program_spans


def _load(run) -> Optional[Program]:
    buf = _fetch()
    reqs = getattr(run, "reqs", None) or []
    if not buf or not buf["spans"] or not reqs:
        return None
    lo = int((min(r.t_send for r in reqs) - 1e-3) * 1e9)
    hi = int(run.deadline * 1e9)
    by_req: Dict[int, list] = collections.defaultdict(list)
    for s in buf["spans"]:
        by_req[s.request].append(s)
    requests = []
    for rid, spans in by_req.items():
        root = next((s for s in spans if s.id == rid and s.parent == 0), None)
        if root is not None and lo <= root.t0 <= hi:
            requests.append(Request(root, spans))
    requests.sort(key=lambda r: r.root.t0)
    slice_ = None
    path = os.path.join(SCRATCH, "slice_trace.json")
    if getattr(run, "device", None) and buf["clock"] and os.path.exists(path):
        with open(path) as f:
            slice_ = Slice(json.load(f), tuple(buf["clock"]))
    return Program(requests, slice_, int(buf["dropped"]))


def _of(run, route: str) -> List[Request]:
    prog = load(run)
    if prog is None:
        return []
    return [r for r in prog.requests if r.root.name == route]


def median(run, route: str, fn: Callable[[Request], Optional[float]]):
    """Median over the window's requests of ``route`` of ``fn(request)``
    (requests where it is None left out); None when none has one."""
    v = [x for x in map(fn, _of(run, route)) if x is not None]
    return stats.median(v) if v else None


def pairs(run, first: str, second: str) -> List[Tuple[Request, Request]]:
    """Each request of route ``second`` with the request just before it on
    its thread, where that one is of route ``first``."""
    prog = load(run)
    if prog is None:
        return []
    last: Dict[int, Request] = {}
    out = []
    for r in prog.requests:
        prev = last.get(r.root.tid)
        if (r.root.name == second and prev is not None
                and prev.root.name == first):
            out.append((prev, r))
        last[r.root.tid] = r
    return out


def launches(run, route: str, name: str) -> Optional[float]:
    """Median a request of ``route``, over its requests wholly inside the
    slice, of the enqueuing calls made inside its spans called ``name``;
    nothing when the slice holds no enqueuing call of their threads."""
    prog = load(run)
    if prog is None or prog.slice is None or prog.slice.h is None:
        return None
    sl = prog.slice
    v, threads = [], set()
    for r in _of(run, route):
        spans = r.named(name)
        if spans and sl.inside(r.root):
            v.append(sum(sl.count_calls(s) for s in spans))
            threads.add(thread_of(r.root))
    if not any(sl.calls.get(t) for t in threads):
        return None
    return stats.median(v)


def idle_in_program_pct(run, cell: str) -> Optional[float]:
    """The device's idle share while a root span was open (≤ the slice's
    idle share); writes the whole attribution for ``cell``."""
    prog = load(run)
    d = getattr(run, "device", None)
    if (prog is None or prog.slice is None or prog.slice.h is None
            or not d or d["window_s"] <= 0 or d["busy_s"] <= 0):
        return None
    att = attribution(prog)
    if att["idle_ms"] <= 0:
        return None
    write_attribution(att, cell)
    idle_pct = 100.0 * (1.0 - d["busy_s"] / d["window_s"])
    return idle_pct * (att["idle_ms"] - att["idle_ms_by_span"][OUTSIDE]) \
        / att["idle_ms"]


def attribution(prog: Program) -> dict:
    """Idle ms of the slice by innermost open span (a path of names from
    the root) and "outside", and how many enqueuing calls of the serving
    threads fall inside a root span of their thread."""
    sl = prog.slice
    h0, h1 = sl.h
    idle = _complement(sl.busy, h0, h1)
    spans, depth, path = [], {}, {}
    for r in prog.requests:
        by_id = {s.id: s for s in r.spans}
        for s in r.spans:
            a, b = sl.interval(s)
            a, b = max(a, h0), min(b, h1)
            if a >= b:
                continue
            names, p, n = [], s, 0
            while p is not None:
                names.append(p.name)
                p, n = by_id.get(p.parent), n + 1
            depth[s.id], path[s.id] = n, " > ".join(reversed(names))
            spans.append((a, b, s.id))
    by: Dict[str, float] = collections.defaultdict(float)
    events = sorted({h0, h1, *(t for a, b, _ in spans for t in (a, b))})
    starts = collections.defaultdict(list)
    stops = collections.defaultdict(list)
    for a, b, sid in spans:
        starts[a].append(sid)
        stops[b].append(sid)
    idle_cum = _cumulative(idle)
    open_: set = set()
    for t0, t1 in zip(events, events[1:]):
        open_.difference_update(stops[t0])
        open_.update(starts[t0])
        ms = (_covered(idle, idle_cum, t1) - _covered(idle, idle_cum, t0)) \
            / 1e3
        if ms > 0:
            key = (path[max(open_, key=lambda i: (depth[i], i))]
                   if open_ else OUTSIDE)
            by[key] += ms
    by.setdefault(OUTSIDE, 0.0)
    # the clocks agree when the serving threads' enqueuing calls fall
    # inside their requests' root spans
    roots: Dict[int, list] = collections.defaultdict(list)
    for r in prog.requests:
        roots[thread_of(r.root)].append(sl.interval(r.root))
    n_calls = n_in = 0
    for tid, ivs in roots.items():
        ivs.sort()
        for ts in sl.calls.get(tid, []):
            n_calls += 1
            i = bisect.bisect_right(ivs, (ts, float("inf"))) - 1
            n_in += i >= 0 and ivs[i][0] <= ts <= ivs[i][1]
    other = sum(len(v) for t, v in sl.calls.items() if t not in roots)
    return {
        "slice_ms": (h1 - h0) / 1e3,
        "busy_ms": stats.union_length(sl.busy) / 1e3,
        "idle_ms": sum(b - a for a, b in idle) / 1e3,
        "idle_ms_by_span": dict(sorted(by.items(), key=lambda kv: -kv[1])),
        "requests": len(prog.requests),
        "dropped_spans": prog.dropped,
        "serving_calls": n_calls,
        "serving_calls_in_root_share": n_in / n_calls if n_calls else None,
        "calls_on_threads_without_spans": other,
        # which ids the trace and the program gave the threads
        "call_threads": {str(t): len(v) for t, v in sl.calls.items()},
        "span_threads": sorted({(r.root.tid, thread_of(r.root))
                                for r in prog.requests}),
    }


def write_attribution(att: dict, cell: str) -> None:
    os.makedirs(SCRATCH, exist_ok=True)
    with open(os.path.join(SCRATCH, f"idle_by_span.{cell}.json"), "w") as f:
        json.dump(att, f, indent=1)


def _merge(iv) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _complement(busy, h0: float, h1: float) -> List[Tuple[float, float]]:
    out, t = [], h0
    for a, b in busy:
        if a > t:
            out.append((t, min(a, h1)))
        t = max(t, b)
    if t < h1:
        out.append((t, h1))
    return [(a, b) for a, b in out if b > a]


def _cumulative(iv) -> List[float]:
    c, out = 0.0, []
    for a, b in iv:
        out.append(c)
        c += b - a
    return out


def _covered(iv, cum, t: float) -> float:
    """Length of the sorted disjoint intervals ``iv`` before ``t``."""
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    if i < 0:
        return 0.0
    a, b = iv[i]
    return cum[i] + (min(t, b) - a)
