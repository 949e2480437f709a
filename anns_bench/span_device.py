"""Device time of the kernels that a program span launched, and the
program's counters, in a traced run.

The program's spans come mapped onto the profiled slice by
program_spans.py. Here each enqueuing call of the slice (a CUDA runtime or
driver call whose correlation id has a device operation) is kept with the
device operations of its correlation id, so the device time of what a span
launched is the sum over the calls its thread made inside it. The
program's counters (``prefhetch_tpu_torch/utils/stages.py`` ``count``)
come from the same buffer as its spans, each with its span and request.

A program without the recorder or without counters, a run without a slice,
a span that is not wholly inside the slice, or a slice that lost the
device's records of a stage (``captured``) reads nothing (None).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
from typing import Dict, List, Optional, Tuple

from anns_bench import program_spans
from anns_bench.cell import SCRATCH
from anns_bench.program_spans import CALL_CATS, cupti_tid, thread_of
from anns_bench.tracing import GPU_CATS

ROUTE = "POST /pir-fetch"
# DevicePIR2's stages that launch device work in every request
DEVICE_STAGES = ("expansion (K2 + elementwise)", "dim-1 fold")


class Launches:
    """The slice's enqueuing calls by thread, in trace µs, each with the
    (µs, name) of the device operations of its correlation id."""

    def __init__(self, trace: dict):
        ev = trace["traceEvents"]
        ops: Dict[int, list] = collections.defaultdict(list)
        for e in ev:
            c = e.get("args", {}).get("correlation")
            if e.get("cat") in GPU_CATS and c is not None:
                ops[c].append((float(e["dur"]), e.get("name", "")))
        calls: Dict[int, list] = collections.defaultdict(list)
        for e in ev:
            c = e.get("args", {}).get("correlation")
            if e.get("cat") in CALL_CATS and c in ops:
                calls[cupti_tid(int(e.get("tid", 0)))].append(
                    (float(e["ts"]), c))
        self.ops = ops
        self.calls = {t: sorted(v) for t, v in calls.items()}

    def of(self, sl, span, name: str = "") -> Tuple[float, int]:
        """(device µs, device operations) launched inside ``span`` on its
        thread, of the operations whose name holds ``name``."""
        a, b = sl.interval(span)
        v = self.calls.get(thread_of(span), [])
        lo = bisect.bisect_left(v, (a, float("-inf")))
        hi = bisect.bisect_right(v, (b, float("inf")))
        us, k = 0.0, 0
        for _, c in v[lo:hi]:
            for dur, op in self.ops[c]:
                if name in op:
                    us += dur
                    k += 1
        return us, k


def load(run):
    """(program spans, Launches, {request id: {counter: total}}) of the run,
    read once (kept on ``run``); None without spans or a slice."""
    if "_span_device" not in vars(run):
        run._span_device = _load(run)
    return run._span_device


def _load(run):
    prog = program_spans.load(run)
    path = os.path.join(SCRATCH, "slice_trace.json")
    if (prog is None or prog.slice is None or prog.slice.h is None
            or not os.path.exists(path)):
        return None
    with open(path) as f:
        launches = Launches(json.load(f))
    counts: Dict[int, Dict[str, int]] = collections.defaultdict(dict)
    for c in _counters():
        d = counts[c.request]
        d[c.name] = d.get(c.name, 0) + c.n
    return prog, launches, counts


def _counters() -> list:
    """The program's counters, or [] from a program that keeps none."""
    from prefhetch_tpu_torch.utils import stages

    get = getattr(stages, "recorded_spans", None)
    return (get() if get is not None else {}).get("counters") or []


def requests(run) -> List:
    """The window's /pir-fetch requests."""
    got = load(run)
    if got is None:
        return []
    return [r for r in got[0].requests if r.root.name == ROUTE]


def _stage(run, name: str) -> List[Tuple[object, float, int]]:
    """(request, device ms, device operations) of every /pir-fetch request
    whose span ``name`` lies wholly inside the slice: all it launched."""
    got = load(run)
    if got is None:
        return []
    prog, launches, _ = got
    out = []
    for r in requests(run):
        spans = r.named(name)
        if spans and all(prog.slice.inside(s) for s in spans):
            got = [launches.of(prog.slice, s) for s in spans]
            out.append((r, sum(us for us, _ in got) / 1e3,
                        sum(k for _, k in got)))
    return out


def span_ms(run, name: str) -> List[Tuple[object, float]]:
    """(request, device ms) of every /pir-fetch request whose span ``name``
    lies wholly inside the slice and launched device work there."""
    return [(r, ms) for r, ms, k in _stage(run, name) if k]


def captured(run) -> bool:
    """False where a stage that always launches device work lies wholly
    inside the slice and the slice holds none of it: the profiler lost the
    device's records, and the slice reads nothing."""
    return all(k for name in DEVICE_STAGES for _, _, k in _stage(run, name))


def counters(run, request) -> Dict[str, int]:
    """The request's counters ({} from a program that counts nothing)."""
    got = load(run)
    return {} if got is None else got[2].get(request.root.request, {})


def kernel_ms(run, request, name: str) -> Optional[Tuple[float, int]]:
    """(device ms, launches) of the kernels whose name holds ``name``
    launched inside the request's root span, where it lies wholly inside
    the slice."""
    got = load(run)
    if got is None or not got[0].slice.inside(request.root):
        return None
    us, k = got[1].of(got[0].slice, request.root, name)
    return us / 1e3, k
