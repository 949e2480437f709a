"""Where the headline's cold window comes from: per-step times of the bench's
``query_pipeline`` step at its operating point, with the card's SM clock
sampled beside them, right after the dataset build, hot, after idle spells,
and on a pipeline prepared anew.

    python -m prefhetch_tpu_torch.tools.bench_warmup [--cache DIR]
        [--steps 200] [--idle 5,30,120] [--out FILE]

Each run queues ``--steps`` steps with a CUDA event between each two and
synchronises once, as ``bench.core.timed_qps`` times them; it records each
step's device time (event to event), each step's host enqueue time, the
run's host-clock rate, and ``nvidia-smi``'s clocks.sm, pstate and
power.draw sampled every 10 ms while it runs. One JSON object per run on
stdout (and the whole in ``--out``).

Reading it: a slow first window that comes back after every idle spell and
follows the SM clock is the clock's ramp from idle; one that shows only on
the first run, or on each pipeline prepared anew, is lazy set-up; one with
slow host enqueue times and short device times is the host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from prefhetch_tpu_torch.bench.core import pipeline
from prefhetch_tpu_torch.bench.data import (
    BenchConfig, get_dataset, get_index,
)

SMI_FIELDS = "clocks.sm,clocks.max.sm,pstate,power.draw"


def smi_once() -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


class ClockSampler:
    """nvidia-smi's own loop (``-lms 10``) in the background; ``stop``
    returns its samples in order."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "10"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        time.sleep(0.2)                 # let its loop start

    def stop(self) -> list:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for ln in out.strip().splitlines():
            parts = [p.strip() for p in ln.split(",")]
            if len(parts) == 4 and parts[0].isdigit():
                rows.append({"sm_mhz": int(parts[0]),
                             "max_mhz": int(parts[1]), "pstate": parts[2],
                             "power_w": float(parts[3])})
        return rows


def run(label: str, step, args, nq: int, steps: int) -> dict:
    """``steps`` queued steps, an event between each two, one sync."""
    torch.cuda.synchronize()
    before = smi_once()
    sampler = ClockSampler()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    host = []
    t0 = time.perf_counter()
    evs[0].record()
    for i in range(steps):
        th = time.perf_counter()
        step(*args)
        evs[i + 1].record()
        host.append((time.perf_counter() - th) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clocks = sampler.stop()
    dev = [evs[i].elapsed_time(evs[i + 1]) for i in range(steps)]
    w = 20                                # bench.core's N_BATCHES
    return {
        "run": label,
        "smi_before": before,
        "smi_after": smi_once(),
        "qps_all": nq * steps / wall,
        "qps_first_20_device": nq * w / (sum(dev[:w]) / 1e3),
        "qps_last_20_device": nq * w / (sum(dev[-w:]) / 1e3),
        "device_ms": [round(x, 4) for x in dev],
        "host_enqueue_ms": [round(x, 4) for x in host],
        "sm_mhz_samples": [c["sm_mhz"] for c in clocks],
        "power_w_samples": [c["power_w"] for c in clocks],
        "pstates": sorted({c["pstate"] for c in clocks}),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m prefhetch_tpu_torch.tools.bench_warmup")
    ap.add_argument("--cache", default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--idle", default="5,30,120",
                    help="idle spells in seconds, comma-separated")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    cfg = BenchConfig.from_env(cache=a.cache)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = get_dataset(cfg)
    index = get_index(cfg, data, dev)
    build_s = time.perf_counter() - t0
    base_t = torch.as_tensor(data["base"], dtype=torch.float32, device=dev)
    pool = data["query"].astype(np.float32)
    q_run = np.tile(pool, (-(-cfg.dev_batch // len(pool)), 1))[
        : cfg.dev_batch]

    def prepare():
        step, args, _ = pipeline(cfg, index, base_t, q_run, dev)
        step(*args)                       # one warm step, as bench.py
        torch.cuda.synchronize()
        return step, args

    results = [{"build_s": build_s, "smi_after_build": smi_once(),
                "nbase": cfg.nbase, "dev_batch": cfg.dev_batch}]
    step, args = prepare()
    results.append(run("after build", step, args, cfg.dev_batch, a.steps))
    results.append(run("hot", step, args, cfg.dev_batch, a.steps))
    for idle in (float(s) for s in a.idle.split(",") if s):
        time.sleep(idle)
        results.append(run(f"after {idle:g} s idle", step, args,
                           cfg.dev_batch, a.steps))
    fresh = prepare()
    results.append(run("prepared anew, hot", *fresh, cfg.dev_batch, a.steps))
    for r in results:
        if "device_ms" not in r:
            print(json.dumps(r), flush=True)
            continue
        dev_ms, host_ms = r["device_ms"], r["host_enqueue_ms"]
        clk = r["sm_mhz_samples"] or [0]
        print(json.dumps({
            **{k: r[k] for k in ("run", "smi_before", "smi_after", "qps_all",
                                 "qps_first_20_device",
                                 "qps_last_20_device", "pstates")},
            "device_ms_first_10": dev_ms[:10],
            "device_ms_mean_first_20": float(np.mean(dev_ms[:20])),
            "device_ms_mean_last_20": float(np.mean(dev_ms[-20:])),
            "host_ms_mean_first_20": float(np.mean(host_ms[:20])),
            "host_ms_mean_last_20": float(np.mean(host_ms[-20:])),
            "sm_mhz_first_5": clk[:5], "sm_mhz_min": min(clk),
            "sm_mhz_max": max(clk), "n_clock_samples": len(clk),
        }), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    main()
