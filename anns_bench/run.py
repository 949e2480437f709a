"""One run of one cell of the benchmark.

    python3 -m anns_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Makes the cell's corpus and queries on the card from the seed, sets the
program up as the configuration states (index build, engine, dispatcher),
makes every request body, warms up, then runs the cell's traffic for
``--seconds``. Set-up (``setup_s``) runs from process start to the first
timed request. After the window: the peak device memory, then (traced run)
the replay of the kept calls, then the program is stopped and freed, and
the plain reference judges every answer with the judge of the cell's
route. The host's readings around the run (hostdiag.py) go to
``.scratch/host.<cell>.<seed>.t<trace>.json``. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit, which also end standard
error.

The process runs with glibc's allocator thresholds fixed (``fix_allocator``),
a host setting of every deployment the benchmark measures.

Exits 2 without a result when there is no CUDA device (or fewer than the
cell asks for), and 3 when jax, jaxlib, flax, ml_dtypes or the JAX package
are loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from anns_bench.cell import (  # noqa: E402
    SCRATCH, Cell, configure_caches, load, load_cell,
)
from anns_bench.hostdiag import Host  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "prefhetch_tpu")

# mallopt parameters: M_MMAP_THRESHOLD 32 MiB (glibc's largest), no trim
# below 1 GiB, the heap grown 64 MiB at a time
MALLOPT = ((-3, 32 << 20), (-1, 1 << 30), (-2, 64 << 20))


def fix_allocator() -> None:
    """Fix glibc's mmap and trim thresholds for the whole process. Left
    dynamic, glibc hands freed heap back to the system and the next
    request faults it in again: on the card's host that costs the serving
    thread 5-13% of its time in system calls for the first minute or more,
    and runs spread with how long that lasts. A request's work is the
    same either way."""
    libc = ctypes.CDLL(None)
    for param, value in MALLOPT:
        if libc.mallopt(param, value) != 1:
            raise RuntimeError(f"mallopt({param}, {value}) refused")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: prefhetch_tpu_torch is not prefhetch_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def check_slice(slice_out: dict, reqs: list) -> None:
    """A profiled slice in which requests completed but no device operation
    shows is a broken trace, not an idle device: fail the run."""
    begin, end = slice_out["span"]
    done = sum(begin <= r.t_done <= end for r in reqs)
    if done and not slice_out["device_ops"]:
        raise RuntimeError(f"the profiled slice holds no device operation "
                           f"while {done} requests completed in it")


class Run:
    """What the metric readers read (metrics/<name>.py ``read(run)``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device=None, t_start: Optional[float] = None,
            host: Optional[Host] = None) -> dict:
    """The run after the look for a chip; returns the result object."""
    import torch

    from anns_bench import judge, tracing
    from anns_bench.data import generate
    from anns_bench.reference import Reference
    from anns_bench.sut import System
    from anns_bench.traffic import Traffic

    t_start = T_START if t_start is None else t_start
    host = host or Host(t_start)
    host.mark("harness modules")
    os.makedirs(SCRATCH, exist_ok=True)     # traces
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    data = generate(cfg["dataset"], seed, dev)
    host.mark("data (CUDA context, draw, copy to host)")
    system = System(cfg, data, dev, int(mix["rows_per_request"]), host)
    tracer = tracing.Tracer(trace)
    traffic = Traffic(mix, cfg, system, data["query"], seed, tracer, host)
    try:
        traffic.prepare()
        host.mark("client prepare")
        traffic.warm()
        if cuda:
            torch.cuda.synchronize(dev)
        host.mark("warm")
        tracer.install(system)
        host.mark("tracer")
        host.probe("before")
        host.mark("probe")
        slice_out = {}

        def during():
            off, length = tracing.slice_window(seconds)
            time.sleep(max(0.0, t0 + off - time.monotonic()))
            begin = time.monotonic()
            slice_out.update(tracing.device_slice(SCRATCH, length))
            slice_out["span"] = (begin, time.monotonic())

        t0 = time.monotonic() + 0.05
        setup_s = t0 - t_start
        host.mark("to t0", t0)
        reqs = traffic.run_window(t0, seconds,
                                  during if (trace and cuda) else None)
        host.probe("after")
        if trace and cuda:
            check_slice(slice_out, reqs)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        replay = tracer.replay(SCRATCH, dev) if (trace and cuda) else None
        tracer.uninstall()
        tracer.scan_calls, tracer.ntt_calls = [], []
    finally:
        traffic.close()
        system.close()
    answers = traffic.answers(reqs)
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = Reference(data["base"], dev)
    k = int(cfg["protocol"]["k"])
    numbers, recall = load("routes", mix["route"]).judge(
        ref, data["query"], answers["qidx"], answers["ids"], answers["dist"],
        answers["failed"], k)
    correct, checks = judge.check(numbers, cfg["checks"])
    run = Run(seconds=seconds, setup_s=setup_s, reqs=reqs,
              rows=int(mix["rows_per_request"]), deadline=t0 + seconds,
              peak_bytes=peak, recall=recall,
              tracer=tracer, device=slice_out or None, replay=replay)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(reqs),
           "failed": int(answers["failed"]), "metrics": metrics,
           "device": dev_info}
    if replay:
        out["bound_by"] = {k: sorted({c[2] for c in v}) for k, v in
                           replay.items() if v}
    if slice_out:
        dev_info["busy_s"] = slice_out["busy_s"]
        dev_info["window_s"] = slice_out["window_s"]
        out["breakdown"] = {"device_ops": slice_out["device_ops"],
                            "idle_gaps": slice_out["idle_gaps"]}
    out["card"] = card() if cuda else dev.type
    out["bodies_rebuilt"] = traffic.rebuilt
    out["warm_failed"] = traffic.warm_failed
    out["checks"] = checks
    host.write(os.path.join(SCRATCH, f"host.{cell.name}.{seed}.t{int(trace)}"
                            ".json"),
               {"cell": cell.name, "seed": seed, "setup_s": setup_s,
                "metrics": metrics, "attempted": len(reqs),
                "correct": correct, "torch_threads": torch.get_num_threads(),
                "card": out["card"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    fix_allocator()
    cell = load_cell(a.workload)
    host = Host(T_START)
    host.mark("harness imports and the cell")
    configure_caches()
    import torch

    host.mark("import torch")
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    host.mark("cuda check")
    out = execute(cell, a.seed, a.seconds, bool(a.trace), host=host)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        lim = ("max", c["max"]) if "max" in c else ("min", c["min"])
        print(f"check {name} {c['value']!r} {lim[0]} {lim[1]!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
