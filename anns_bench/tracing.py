"""The traced run's instrumentation, all from the harness's side.

- Spans: the harness times its own calls into the program (``Dispatcher``
  routes) and wraps, at run time and in the traced run only, the engine
  methods below them (``search_fused``, ``coarse_search_topk``,
  ``encrypted_precise_search``, ``_tiled_batch_prep``). A request's spans
  and the program's own ``record_stages()`` stages land in that request's
  record; every call's span also lands in ``calls``.
- Device slice: ``torch.profiler`` over a steady slice of the window; the
  union of kernel, copy and set intervals is the device's busy time.
- Replay: the first calls of the scan stage (``union_scan_pruned_fused``)
  and of the NTT entry points (``ntt4``/``intt4``) in the window are kept
  with their inputs and run again after the window under ``torch.profiler``,
  each in a ``record_function`` range, for the device time of every kernel
  launched inside it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Tuple

import torch

from anns_bench import roofline, stats

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCAN_KEEP = 16          # scan calls kept for the replay
NTT_KEEP = 64           # NTT calls kept (a packed request makes 52)


class Tracer:
    """Spans of the traced run; a disabled tracer only forwards calls."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.calls: Dict[str, List[float]] = collections.defaultdict(list)
        self.scan_calls: list = []
        self.ntt_calls: list = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._undo: list = []
        self._tile_sizes = None

    # -- spans -------------------------------------------------------------
    def _add(self, name: str, ms: float) -> None:
        with self._lock:
            self.calls[name].append(ms)
        spans = getattr(self._local, "spans", None)
        if spans is not None:
            spans[name] = spans.get(name, 0.0) + ms

    def timed(self, name: str, fn, *args):
        if not self.enabled:
            return fn(*args)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self._add(name, (time.perf_counter() - t0) * 1e3)

    @contextlib.contextmanager
    def request(self):
        """Around one request in a client thread: yields the dict its spans
        and the program's recorded stages go to (None when disabled)."""
        if not self.enabled:
            yield None
            return
        from prefhetch_tpu_torch.utils.stages import record_stages

        spans: dict = {}
        self._local.spans = spans
        try:
            with record_stages() as st:
                yield spans
        finally:
            self._local.spans = None
            spans.update({f"stage:{k}": v for k, v in st.items()})

    # -- wrapping the program -----------------------------------------------
    def _patch(self, owner, attr: str, wrapper) -> None:
        orig = getattr(owner, attr)
        in_dict = attr in vars(owner)
        setattr(owner, attr, wrapper(orig))
        self._undo.append((owner, attr, orig, in_dict))

    def install(self, system) -> None:
        if not self.enabled:
            return
        import prefhetch_tpu_torch.engine.hecompute as hecompute
        import prefhetch_tpu_torch.engine.server as server

        from torch.profiler import ProfilerActivity, profile

        if system.device.type == "cuda":
            # the first profiler session of a process takes seconds to
            # start (CUPTI): pay it in set-up, not inside the window
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.ones(1, device=system.device).add_(1)
        eng = system.engine
        for meth in ("search_fused", "coarse_search_topk",
                     "encrypted_precise_search", "_tiled_batch_prep"):
            self._patch(eng, meth, lambda f, m=meth: (
                lambda *a, **kw: self.timed(f"engine.{m}",
                                            lambda: f(*a, **kw))))
        view = eng._tiled_view
        self._tile_sizes = view.tile_sizes_np

        def keep_scan(f):
            # (payload, norms, sizes, queries, union, pos, j_keep): the
            # index's tensors are static; the batch's own are cloned
            def wrapped(*a):
                if len(self.scan_calls) < SCAN_KEEP:
                    with self._lock:
                        self.scan_calls.append(
                            (*a[:3], *(x.clone() for x in a[3:6]), a[6]))
                return f(*a)
            wrapped.orig = f
            return wrapped

        self._patch(server, "union_scan_pruned_fused", keep_scan)

        def keep_ntt(f, inverse: bool):
            def wrapped(x, tb, *rest):
                if len(self.ntt_calls) < NTT_KEEP:
                    with self._lock:
                        self.ntt_calls.append((x.clone(), tb, inverse))
                return f(x, tb, *rest)
            wrapped.orig = f
            return wrapped

        self._patch(hecompute, "ntt4", lambda f: keep_ntt(f, False))
        self._patch(hecompute, "intt4", lambda f: keep_ntt(f, True))

    def uninstall(self) -> None:
        for owner, attr, orig, in_dict in reversed(self._undo):
            if in_dict:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()

    # -- after the window -----------------------------------------------------
    def replay(self, scratch: str, device: torch.device) -> dict:
        """Device time and the contract's bound of the kept scan and NTT
        calls → {"scan": [(bound_s, device_s, by)], "ntt": [...]}."""
        import prefhetch_tpu_torch.engine.hecompute as hecompute
        import prefhetch_tpu_torch.engine.server as server

        scan_fn = server.union_scan_pruned_fused
        scan_fn = getattr(scan_fn, "orig", scan_fn)
        ntt_fns = {False: getattr(hecompute.ntt4, "orig", hecompute.ntt4),
                   True: getattr(hecompute.intt4, "orig", hecompute.intt4)}
        jobs = []
        for a in self.scan_calls:
            payload, union, pos, j = a[0], a[4], a[5], a[6]
            nbytes, flops = roofline.scan_work(
                self._tile_sizes, union.cpu().numpy(), pos.cpu().numpy(),
                d=payload.shape[2], tile=payload.shape[1], j_keep=int(j),
                payload_bytes=payload.element_size())
            jobs.append(("scan", lambda a=a: scan_fn(*a),
                         roofline.bound_s(nbytes, flops)))
        for x, tb, inverse in self.ntt_calls:
            nbytes = roofline.ntt_work(x.shape[0], x.shape[1],
                                       x.element_size(), tb.n1, tb.n2)
            jobs.append(("ntt", lambda x=x, tb=tb, i=inverse:
                         ntt_fns[i](x, tb), roofline.bound_s(nbytes)))
        if not jobs:
            return {"scan": [], "ntt": []}
        for _, fn, _ in jobs:            # untimed: first-call effects
            fn()
        torch.cuda.synchronize(device)
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i, (kind, fn, _) in enumerate(jobs):
                with record_function(f"anns.{kind}#{i}"):
                    fn()
            torch.cuda.synchronize(device)
        path = os.path.join(scratch, "replay_trace.json")
        prof.export_chrome_trace(path)
        dev_s = annotated_device_seconds(path, "anns.")
        out: Dict[str, list] = {"scan": [], "ntt": []}
        for i, (kind, _, (b, by)) in enumerate(jobs):
            out[kind].append((b, dev_s.get(f"anns.{kind}#{i}", 0.0), by))
        return out


def _events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def annotated_device_seconds(path: str, prefix: str) -> Dict[str, float]:
    """{range name: seconds of the device operations launched inside it},
    joining each range's runtime calls on its thread to their device
    operations by correlation id."""
    ev = _events(path)
    ranges = [e for e in ev if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(prefix)]
    runtime = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    device = {}
    for e in ev:
        if e.get("cat") in GPU_CATS:
            c = e.get("args", {}).get("correlation")
            device[c] = device.get(c, 0.0) + float(e["dur"]) * 1e-6
    out = {}
    for r in ranges:
        t0, t1 = r["ts"], r["ts"] + r["dur"]
        corr = {e["args"].get("correlation") for e in runtime
                if e.get("tid") == r.get("tid") and t0 <= e["ts"] <= t1}
        out[r["name"]] = sum(device.get(c, 0.0) for c in corr)
    return out


def device_slice(scratch: str, seconds: float) -> dict:
    """Profile the device for ``seconds`` (the caller's threads keep
    serving) → {"busy_s", "window_s", "device_ops", "idle_gaps"}."""
    from torch.profiler import ProfilerActivity, profile

    # CUDA activity is recorded for every thread of the process, so the
    # serving threads' launches show though this thread only sleeps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        time.sleep(seconds)
        window = time.perf_counter() - t0
    path = os.path.join(scratch, "slice_trace.json")
    prof.export_chrome_trace(path)
    ev = _events(path)
    ops = [(float(e["ts"]) * 1e-6, float(e["ts"] + e["dur"]) * 1e-6,
            e.get("name", "?"))
           for e in ev if e.get("cat") in GPU_CATS]
    busy = stats.union_length((s, e) for s, e, _ in ops)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, n in ops:
        by_name[_short(n)] += e - s
    return {
        "busy_s": busy,
        "window_s": window,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": _gaps(sorted(ops))[:10],
    }


def _short(name: str) -> str:
    name = name.replace("void ", "")
    return name[:80]


def _gaps(ops: List[Tuple[float, float, str]]) -> List[list]:
    """The longest idle stretches between busy ones, named by the device
    operations on either side."""
    out = []
    end, last = None, None
    for s, e, n in ops:
        if end is not None and s > end:
            out.append([f"after {_short(last)} / before {_short(n)}", s - end])
        if end is None or e > end:
            end, last = e, n
    return sorted(out, key=lambda g: -g[1])


def slice_window(seconds: float) -> Tuple[float, float]:
    """(start offset, length) of the profiled slice inside a window."""
    length = min(3.0, 0.3 * seconds)
    return 0.4 * seconds, length
