"""``python -m prefhetch_tpu_torch.bench [--device cpu] [--cache DIR]`` —
bench.py ``main`` (:521-1197) for the port.

Prints ONE JSON line on stdout: ``{"metric": "ivfpq_query_pipeline_qps",
"value", "unit": "queries/sec", "vs_baseline", "extra": {...}}``. The
headline runs first, then the sections in bench.py's order (encrypted,
http, ckks, pq, pir, angular, hard), a purge of the device's holders before
pir, angular and hard. Progress, each section's seconds and the kernel
launches of each section go to stderr.

No failure is hidden: a section that raises, fails a check or runs past its
cap records ``<name>_error`` in the line, as does one the deadline leaves no
time for; the process then exits 1 after printing the line. Only
``PFH_BENCH_SKIP_*`` leaves a section out, listed under ``extra.skipped``. A
SIGTERM, SIGINT or the deadline's backstop (SIGALRM) prints the line so far
with ``aborted_by`` and exits with 128 + the signal's number. Without CUDA
(and without ``--device cpu``) it exits 2 and prints no line.
"""

from __future__ import annotations

import argparse
import gc
import json
import signal
import sys
import time
import traceback
from typing import Callable, Optional

import torch

from prefhetch_tpu_torch.bench import core, encrypted, http, pir
from prefhetch_tpu_torch.bench.data import (
    SECTIONS, BenchConfig, get_dataset, get_index,
)
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.ops import kernel_counters

# bench.py's estimates of each section's seconds: a section starts only
# with this much of the deadline left, and runs at most twice it
EST_S = {"encrypted": 150, "http": 120, "ckks": 150, "pq": 120, "pir": 150,
         "angular": 120, "hard": 120}
# the sections after which the device's holders are dropped
PURGE_BEFORE = ("pir", "angular", "hard")


class SectionTimeout(BaseException):
    """A section's cap ran out. A BaseException, so that no ``except
    Exception`` inside a section can swallow it."""


class Bench:
    """One run: the result line, the failures, and what the sections share
    (the headline's data, index, ids and device tensors), dropped by
    ``purge``."""

    def __init__(self, cfg: BenchConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.t0 = time.time()
        self.result = {
            "metric": "ivfpq_query_pipeline_qps", "value": 0.0,
            "unit": "queries/sec", "vs_baseline": 0.0,
            "extra": {"status": "incomplete",
                      "skipped": [n for n, _ in SECTIONS if n in cfg.skip],
                      "section_s": {}},
        }
        self.failed: list = []
        self.shared: dict = {}
        self._emitted = False

    # -- the line ----------------------------------------------------------
    def emit(self) -> None:
        if self._emitted:
            return
        self._emitted = True
        sys.stdout.write(json.dumps(self.result) + "\n")
        sys.stdout.flush()

    def time_left(self) -> float:
        return self.cfg.deadline_s - (time.time() - self.t0)

    def mark(self, msg: str) -> None:
        print(f"[bench] {msg} at {time.time() - self.t0:.1f}s",
              file=sys.stderr, flush=True)

    # -- sections -----------------------------------------------------------
    def _launches(self, name: str, reset: bool) -> None:
        wrappers, plains = kernel_counters()
        if reset:
            for w in wrappers.values():
                w.launches = 0
            for p in plains:
                p.calls = 0
            return
        counts = {k: w.launches for k, w in wrappers.items()}
        calls = sum(p.calls for p in plains)
        print(f"[bench] launches {name} "
              + json.dumps({"launches": counts, "plain_calls": calls}),
              file=sys.stderr, flush=True)

    def section(self, name: str, fn: Callable[[], dict],
                est_s: Optional[float] = None) -> None:
        """Run one section under its cap; its keys (or ``<name>_error``)
        go into the line's extra."""
        extra = self.result["extra"]
        if name in self.cfg.skip:
            return
        left = self.time_left()
        if est_s is not None and left < est_s:
            self.failed.append(name)
            extra[f"{name}_error"] = (f"deadline: {left:.0f}s left < est "
                                      f"{est_s:.0f}s")
            self.mark(f"{name} not run: {extra[f'{name}_error']}")
            return
        cap = None if est_s is None else min(2 * est_s,
                                             max(left - 30.0, est_s))

        def on_cap(signum, frame):
            raise SectionTimeout(f"section cap {cap:.0f}s hit "
                                 f"(est {est_s:.0f}s)")

        old = signal.signal(signal.SIGALRM, on_cap) if cap else None
        if cap:
            signal.setitimer(signal.ITIMER_REAL, cap)
        t_sec = time.time()
        self._launches(name, reset=True)
        try:
            extra.update(fn())
        except (SectionTimeout, Exception) as e:   # noqa: BLE001 — recorded
            traceback.print_exc()
            self.failed.append(name)
            extra[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]
        finally:
            if cap:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
                # the global backstop again
                signal.alarm(max(1, int(self.time_left()) + 90))
        self._launches(name, reset=False)
        extra["section_s"][name] = time.time() - t_sec
        self.mark(f"section {name}: {time.time() - t_sec:.1f}s "
                  f"({self.time_left():.0f}s left)")

    def purge(self, note: str) -> None:
        """Drop every holder of device memory the sections before share,
        so the next section starts on a clean card."""
        from prefhetch_tpu_torch.engine.server import QueryEngine

        before = (torch.cuda.memory_allocated(self.device)
                  if self.device.type == "cuda" else 0)
        self.shared.clear()
        QueryEngine.reset_instance()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            freed = before - torch.cuda.memory_allocated(self.device)
            self.mark(f"purged {freed / 1e9:.2f} GB {note}")

    # -- the run -----------------------------------------------------------
    def core(self) -> dict:
        """The headline; the sections need its data, index and ids."""
        cfg, dev = self.cfg, self.device
        data = get_dataset(cfg)
        index = get_index(cfg, data, dev)
        self.mark("dataset+index ready")
        out = core.run_core(cfg, data, index, dev)
        self.result["value"] = out["value"]
        self.result["vs_baseline"] = out["vs_baseline"]
        self.shared.update(data=data, index=index, ids=out["ids"],
                           base_t=out["base_t"], q_run=out["q_run"])
        return {"status": "core", **out["extra"]}

    def run(self) -> int:
        """Every section; returns the exit code (1 when any failed)."""
        cfg, dev, sh = self.cfg, self.device, self.shared
        self.section("core", self.core)
        if "core" in self.failed:
            return 1
        self.mark(f"core done: {self.result['value']:.0f} q/s")

        data = sh["data"]           # the host arrays outlive the purges

        sections = {
            "encrypted": lambda: encrypted.run_enc(cfg, data, sh["index"],
                                                   sh["ids"], dev),
            "http": lambda: http.http_serving_bench(cfg, data, sh["index"],
                                                    dev),
            "ckks": lambda: encrypted.ckks_scoring_qps(data, sh["ids"], dev),
            "pq": lambda: core.run_pq(cfg, data, sh["index"], sh["base_t"],
                                      sh["q_run"], dev),
            "pir": lambda: pir.run_pir(cfg, data, dev),
            "angular": lambda: core.run_angular(cfg, dev),
            "hard": lambda: core.run_hard(cfg, dev),
        }
        for name, _ in SECTIONS:
            if name in PURGE_BEFORE:
                self.purge(f"before {name}")
            self.section(name, sections[name], EST_S[name])
        extra = self.result["extra"]
        extra["status"] = "complete" if not self.failed else "failed"
        extra["failed"] = list(self.failed)
        extra["bench_wall_s"] = time.time() - self.t0
        return 1 if self.failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m prefhetch_tpu_torch.bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--cache", default=None,
                    help="dataset and index cache (default "
                         "bench_cache/torch/ in the checkout)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    bench = Bench(BenchConfig.from_env(cache=args.cache), device)

    def on_signal(signum, frame):
        bench.result["extra"]["aborted_by"] = signal.Signals(signum).name
        bench.emit()
        raise SystemExit(128 + signum)

    handled = (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)
    old = {s: signal.signal(s, on_signal) for s in handled}
    # the backstop: even a section stuck past every cap ends the run
    signal.alarm(int(bench.cfg.deadline_s) + 90)
    try:
        code = bench.run()
        bench.emit()
        return code
    finally:
        signal.alarm(0)
        for s, h in old.items():
            signal.signal(s, h)


if __name__ == "__main__":
    sys.exit(main())
