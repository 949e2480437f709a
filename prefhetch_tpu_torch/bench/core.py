"""The headline and the sections that time ``pipeline.query_pipeline``
(bench.py ``main`` :521-671, ``run_pq`` :921-972, ``run_angular`` :891-917,
``run_hard`` :828-887).

Each section times the step on the device (queued steps and one
synchronisation for throughput, a synchronisation a step for latency),
scores recall against exact ground truth, and holds the first BATCH queries'
recall@100 within RECALL_GAP of ``numpy_pipeline`` on the same queries and
index; the hard section also holds recall to the exact-IVF oracle's. A check
that fails raises, and fails its section.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from prefhetch_tpu_torch.bench.data import (
    BATCH, COARSE_PROBE, D, K, N_BATCHES, NPROBE, PQ_M, ROOT,
    BenchConfig, get_angular_dataset, get_hard_dataset, get_index,
    ivf_oracle_topk, numpy_pipeline,
)
from prefhetch_tpu_torch.index.tiling import build_tiled_view
from prefhetch_tpu_torch.metrics import benchmark_results
from prefhetch_tpu_torch.pipeline import query_pipeline

# the device's recall@100 may lie this far from the numpy pipeline's on the
# same queries and index: the core scan ranks the PQ reconstruction in bf16
# and prunes to J tiles, the numpy pipeline ranks exact ADC on every
# candidate of the probed lists
RECALL_GAP = 0.02
# the hard workload's funnel widths: (nprobe, coarse_probe)
FRONTIER = ((16, 256), (16, 512), (32, 512), (32, 1024))
WORKER_TIMEOUT_S = 300      # a client worker process's limit
# untimed steps before a timed window. On the H100 (tools/bench_warmup.py,
# 1M): the first step after a pause of the card takes 1.2-2.0x a steady
# step, the second up to 1.3x, and the steps from the third on are steady
# (one run in six had a third step at 1.55x); the SM clock stays at its
# maximum through a dataset build and idle spells of 5-120 s
WARM_STEPS = 3


class CheckFailed(AssertionError):
    """A figure's answer did not hold; its section fails."""


def run_worker(module: str, args: list, timeout: float) -> str:
    """Run ``python -m module args`` (the port found from this checkout)
    and return its stdout; raises with its stderr's end when it fails. The
    worker is killed on a timeout or when this process is interrupted."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", module, *map(str, args)],
        capture_output=True, env=env, timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed ({proc.returncode}): "
                           f"{proc.stderr[-800:].decode(errors='replace')}")
    return proc.stdout.decode()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn: Callable, device: torch.device, n: int = 20) -> float:
    """Mean ms a call of ``fn`` over ``n`` queued calls after one warm
    call: CUDA events on the card, the host clock on the CPU."""
    fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def pipeline(cfg: BenchConfig, index, base_t, queries, device, quant=None,
             view=None, **kw):
    """query_pipeline at the run's settings (``quant`` and ``view`` as
    query_pipeline takes them; nprobe and coarse_probe by keyword)."""
    quant = cfg.quant if quant is None else quant
    kw.setdefault("nprobe", NPROBE)
    kw.setdefault("coarse_probe", COARSE_PROBE)
    return query_pipeline(
        index, base_t, queries, k=K, quant=quant, scan=cfg.scan,
        tile=cfg.tile_for(quant), prune_j=cfg.prune_j, device=device,
        view=view, **kw,
    )


def timed_qps(step, args, nq: int, n: int, device) -> tuple:
    """(queries/s over ``n`` queued steps and one synchronisation, the
    last step's ids on the host), after WARM_STEPS synchronised untimed
    steps."""
    for _ in range(WARM_STEPS):
        _, ids = step(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        _, ids = step(*args)
    sync(device)
    return nq * n / (time.perf_counter() - t0), ids.cpu().numpy()


def recall_vs_numpy(prefix: str, ids: np.ndarray, data, index) -> dict:
    """The numpy pipeline's recall on the first BATCH queries (at most as
    many as ``ids`` holds) and the device's on the same queries; raises
    when their recall@100 differ by more than RECALL_GAP."""
    n = min(BATCH, len(ids))
    gt = data["groundtruth"][:n]
    np_ids = numpy_pipeline(index, data["base"])(
        data["query"][:n].astype(np.float32))
    nrep = benchmark_results(np_ids, gt, k=K)
    rep = benchmark_results(ids[:n], gt, k=K)
    gap = rep.recall_100 - nrep.recall_100
    if abs(gap) > RECALL_GAP:
        raise CheckFailed(
            f"{prefix}recall@100 {rep.recall_100} on {n} queries lies "
            f"{gap:+.4f} from numpy_pipeline's {nrep.recall_100} "
            f"(limit {RECALL_GAP})")
    return {f"{prefix}numpy_recall_at_10": nrep.recall_10,
            f"{prefix}numpy_recall_at_100": nrep.recall_100,
            f"{prefix}numpy_recall_gap_at_100": gap}


def numpy_baseline_qps(cfg: BenchConfig, index, data) -> float:
    """The numpy pipeline's queries/s on 8 queries, the median of 3, cached
    under the operating point: a property of the pipeline, the point and
    the host, not of the run."""
    path = os.path.join(
        cfg.cache, f"npbase_{cfg.nbase}_{D}_{cfg.nlist}_{PQ_M}_{NPROBE}_"
                   f"{COARSE_PROBE}.json")
    if os.path.exists(path):
        with open(path) as f:
            return float(json.load(f)["np_qps"])
    queries = data["query"][:8].astype(np.float32)
    run = numpy_pipeline(index, data["base"])
    run(queries)                        # warm page cache / BLAS pools
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(queries)
        samples.append(len(queries) / (time.perf_counter() - t0))
    np_qps = sorted(samples)[1]
    os.makedirs(cfg.cache, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"np_qps": np_qps, "samples": samples}, f)
    os.replace(tmp, path)
    return np_qps


def run_core(cfg: BenchConfig, data, index, device) -> dict:
    """The headline: ``dev_batch`` queries a step over the pool, N_BATCHES
    steps queued for throughput and N_BATCHES synchronised for latency,
    each stage's time, recall, and the numpy baseline. Returns
    {"value", "vs_baseline", "extra", "ids"} (ids: the last step's)."""
    base_t = torch.as_tensor(data["base"], dtype=torch.float32,
                             device=device)
    pool = data["query"].astype(np.float32)
    reps = -(-cfg.dev_batch // len(pool))
    q_run = np.tile(pool, (reps, 1))[: cfg.dev_batch]  # distinct up to the pool
    step, args, stats = pipeline(cfg, index, base_t, q_run, device)
    qps, ids = timed_qps(step, args, cfg.dev_batch, N_BATCHES, device)

    lat = []
    for _ in range(N_BATCHES):
        tb = time.perf_counter()
        _, out = step(*args)
        sync(device)
        lat.append((time.perf_counter() - tb) * 1e3)
    lat.sort()

    stage_ms = {name: device_ms(fn, device)
                for name, fn in stats["stage_fns"](args).items()}
    dd, dids = step(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(5):
        dd.cpu(), dids.cpu()
    stage_ms["d2h"] = (time.perf_counter() - t0) / 5 * 1e3

    n_score = min(len(data["groundtruth"]), cfg.dev_batch)
    rep = benchmark_results(ids[:n_score], data["groundtruth"][:n_score], k=K)
    scan_bytes = stats["scan_bytes_per_query"]
    extra = {
        "recall_at_10": rep.recall_10,
        "recall_at_100": rep.recall_100,
        **recall_vs_numpy("", ids, data, index),
        "scan_bytes_per_query": scan_bytes,
        "scan_effective_gbps": scan_bytes * qps / 1e9,
        # index memory per vector: FAISS IVFPQ's codes + ids; the bf16
        # reconstruction payload the scan reads is a memory-for-bandwidth
        # trade
        "index_code_bytes_per_vec": PQ_M + 4,
        "scan_payload_bytes_per_vec": 2 * D,
        "batch_p50_ms": lat[len(lat) // 2],
        "batch_p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
        "stage_ms": stage_ms,
        "nbase": cfg.nbase,
        "batch": BATCH,
        "dev_batch": cfg.dev_batch,
        "backend": device.type,
        "device": card_name(device),
    }
    np_qps = numpy_baseline_qps(cfg, index, data)
    extra["numpy_baseline_qps"] = np_qps
    return {"value": qps, "vs_baseline": qps / np_qps, "extra": extra,
            "ids": ids, "base_t": base_t, "q_run": q_run}


def run_pq(cfg: BenchConfig, data, index, base_t, q_run, device) -> dict:
    """The equal-memory point: the PQ codes payload (FAISS IVFPQ serving
    memory, 36 B a vector) scanned by K3 over each query's probed tiles."""
    step, args, stats = pipeline(cfg, index, base_t, q_run, device,
                                 quant="pq")
    qps, ids = timed_qps(step, args, len(q_run), N_BATCHES, device)
    n_score = min(len(data["groundtruth"]), len(q_run))
    rep = benchmark_results(ids[:n_score], data["groundtruth"][:n_score], k=K)
    return {
        "pq_onehot_qps": qps,
        "pq_recall_at_10": rep.recall_10,
        "pq_recall_at_100": rep.recall_100,
        **recall_vs_numpy("pq_", ids, data, index),
        "pq_index_bytes_per_vec": PQ_M + 4,
        "pq_scan_bytes_per_query": stats["scan_bytes_per_query"],
    }


def run_angular(cfg: BenchConfig, device) -> dict:
    """BASELINE config 4: unit-normalised vectors, where squared-L2 order is
    cosine order, through the same pipeline; recall against exact angular
    ground truth."""
    data = get_angular_dataset(cfg)
    index = get_index(cfg, data, device, subdir="angular")
    step, args, _ = pipeline(cfg, index, data["base"],
                             data["query"][:BATCH].astype(np.float32), device)
    qps, ids = timed_qps(step, args, BATCH, N_BATCHES, device)
    rep = benchmark_results(ids, data["groundtruth"][:BATCH], k=K)
    return {
        "angular_qps": qps,
        "angular_recall_at_10": rep.recall_10,
        "angular_recall_at_100": rep.recall_100,
        **recall_vs_numpy("angular_", ids, data, index),
    }


def run_hard(cfg: BenchConfig, device) -> dict:
    """Recall on overlapping heavy-tailed lists, beside the exact-IVF
    oracle's (probing loss alone), which it may not exceed; then the
    recall-vs-throughput frontier over FRONTIER's funnel widths."""
    data = get_hard_dataset(cfg)
    index = get_index(cfg, data, device, subdir="hard")
    hq = data["query"][:BATCH].astype(np.float32)
    gt = data["groundtruth"][:BATCH]
    base_t = torch.as_tensor(data["base"], dtype=torch.float32,
                             device=device)
    view = build_tiled_view(index, tile=cfg.tile_for(cfg.quant),
                            quant=cfg.quant)
    step, args, _ = pipeline(cfg, index, base_t, hq, device, view=view)
    _, ids = step(*args)
    ids = ids.cpu().numpy()
    rep = benchmark_results(ids, gt, k=K)
    orep = benchmark_results(ivf_oracle_topk(data, index), gt, k=K)
    for at in ("recall_10", "recall_100"):
        if getattr(rep, at) > getattr(orep, at):
            raise CheckFailed(
                f"hard {at} {getattr(rep, at)} exceeds the exact-IVF "
                f"oracle's {getattr(orep, at)} over the same probed lists")
    out = {
        "hard_recall_at_10": rep.recall_10,
        "hard_recall_at_100": rep.recall_100,
        "hard_oracle_recall_at_10": orep.recall_10,
        "hard_oracle_recall_at_100": orep.recall_100,
        **recall_vs_numpy("hard_", ids, data, index),
    }
    frontier = []
    for npb, cp in FRONTIER:
        fstep, fargs, _ = pipeline(cfg, index, base_t, hq, device, view=view,
                                   nprobe=npb, coarse_probe=cp)
        fqps, fids = timed_qps(fstep, fargs, BATCH, 3, device)
        frontier.append({
            "nprobe": npb, "coarse_probe": cp,
            "recall_at_100": benchmark_results(fids, gt, k=K).recall_100,
            "qps": fqps,
        })
    out["hard_frontier"] = frontier
    out["hard_best_recall_at_100"] = max(f["recall_at_100"]
                                         for f in frontier)
    return out

