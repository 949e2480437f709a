#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (prefhetch_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Phases, each
reporting on lines of its own; any failure exits non-zero:

1. card     — the card's name and power limit (nvidia-smi) and torch's name;
2. build    — compiles every kernel of the port from csrc/ with nvcc;
3. edges    — each kernel against its plain PyTorch version on the card at
              edge shapes (size-0 and partial tiles, nq not a multiple of
              the query block, an f32 payload, d above one feature stage);
4. main     — the SIFT1M operating point (1M x 128 base, 100K train,
              IVF1024 + PQ32x8 with a bf16 reconstruction payload,
              nprobe=16, COARSE_PROBE=256, K=100): synthetic SIFT-style data
              from the port's generator, the index trained and built on the
              card by QueryEngine.init_index (cold path), GET /query,
              centroid ranking on the card, then POST /search (binary wire)
              for 4 batches of 64 queries through the Dispatcher, with every
              kernel's launch count read around those requests only; each
              kernel is compared with its plain version at the shapes of the
              first batch; recall@10/@100 scored against exact ground truth;
5. timings  — each kernel's time with CUDA events at the main-path shape,
              beside its plain version, a PyTorch library call and the
              card's bound for the same work; printed as one JSON line
              {"kernels": [...]}; then torch.profiler over warm /search
              requests: device time by kernel and the device's busy share;
6. result   — the last line, {"ok": true, "device": {...}}.

Without CUDA, or without the port beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12

NBASE, NTRAIN, D = 1_000_000, 100_000, 128
NQ_BATCH, N_BATCHES = 64, 4
RECALL10_MIN, RECALL100_MIN = 0.95, 0.85


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around iters calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_union_scan_min(name, payload, norms, sizes, q, union,
                         min_atol: float) -> float:
    """K1 against its plain version on the same card tensors. Returns the
    max |d2 difference| over non-PAD lanes (in bf16 values)."""
    import torch

    from prefhetch_tpu_torch.ops import union_scan_min as usm

    d2k, mink = usm.union_scan_min(payload, norms, sizes, q, union)
    torch.cuda.synchronize()              # a fault in the run shows here
    d2r, minr = usm.union_scan_min_reference(payload, norms, sizes, q, union)
    d2k, d2r = d2k.float(), d2r.float()
    pad_k, pad_r = torch.isinf(d2k), torch.isinf(d2r)
    if not torch.equal(pad_k, pad_r):
        raise AssertionError(f"{name}: PAD pattern differs "
                             f"({int((pad_k != pad_r).sum())} lanes)")
    if not torch.isfinite(mink).all() or not torch.isfinite(minr).all():
        raise AssertionError(f"{name}: non-finite tile minimum")
    # d2 is stored bf16: within one bf16 ulp (2^-8 relative) of the plain
    # version, whose f32 sum runs in another order before the same rounding
    ok = ~pad_r
    torch.testing.assert_close(d2k[ok], d2r[ok], rtol=1e-2, atol=0.5)
    # the min is f32 before the cast; the two f32 sums of d products differ
    # only in order (a few ulp of the largest term, min_atol)
    torch.testing.assert_close(mink, minr, rtol=1e-5, atol=min_atol)
    err = float((d2k[ok] - d2r[ok]).abs().max()) if ok.any() else 0.0
    log("kernel", f"{name}: U={union.shape[0]} nq={q.shape[0]} "
        f"T={payload.shape[1]} d={payload.shape[2]} {payload.dtype}: "
        f"ok (max |d2 err| {err})")
    return err


def phase_edges() -> None:
    """K1 at edge shapes on integer-valued SIFT-like data (every product and
    sum is exact in f32, so the minima must agree exactly)."""
    import torch

    g = torch.Generator().manual_seed(7)

    def case(name, ntiles, T, d, nq, dtype, sizes, union):
        payload = torch.randint(0, 256, (ntiles + 1, T, d), generator=g)
        payload[-1] = 0
        for t, s in enumerate(sizes):
            payload[t, s:] = 0
        payload = payload.to(dtype).cuda()
        norms = (payload.float() ** 2).sum(-1).contiguous()
        sizes_t = torch.tensor(sizes, dtype=torch.int32).cuda()
        q = torch.randint(0, 256, (nq, d), generator=g).float().cuda()
        union_t = torch.tensor(union, dtype=torch.int32).cuda()
        check_union_scan_min(name, payload, norms, sizes_t, q, union_t,
                             min_atol=0.0)

    # main-path widths; a full, a partial and a size-0 tile; the empty tile
    # repeated as union padding
    case("edge/partial+empty", 4, 512, 128, 64, torch.bfloat16,
         [512, 37, 0, 300, 0], [0, 1, 2, 3, 4, 4, 4, 4])
    # nq not a multiple of the 64-query block; T not a multiple of 64 rows
    case("edge/nq=70,T=100", 3, 100, 32, 70, torch.bfloat16,
         [100, 1, 64, 0], [2, 0, 1, 3, 3])
    # f32 payload; d = 200 spans two feature stages (128 + 72)
    case("edge/f32,d=200", 3, 64, 200, 5, torch.float32,
         [64, 10, 0, 0], [1, 0, 2, 3])


def profile_search(disp, queries, probes, k: int) -> None:
    """Where a /search request's time goes: torch.profiler over N_BATCHES
    warm requests; device time by kernel and the device's busy share of the
    host wall clock (the rest is host work the device waits on), and the
    host-only batch preparation (probe expansion, union, upload) alone."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from prefhetch_tpu_torch.utils import wire_bin

    reqs = [wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
        queries[b * NQ_BATCH:(b + 1) * NQ_BATCH],
        probes[b * NQ_BATCH:(b + 1) * NQ_BATCH], np.array([k], np.uint32),
    ]) for b in range(N_BATCHES)]
    hdr = {"content-type": wire_bin.CONTENT_TYPE}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            disp.handle("POST", "/search", hdr, r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    busy = (f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% "
            f"of wall)" if rows else "device busy not measured (the "
            "profiler recorded no device events)")
    log("profile", f"{N_BATCHES} warm /search requests: wall {wall_ms:.3f} "
        f"ms, {busy}")
    for dev_us, key, count in rows[:10]:
        log("profile", f"  {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
    t0 = time.perf_counter()
    for b in range(N_BATCHES):
        sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
        disp.engine._tiled_batch_prep(probes[sl], queries[sl])
    torch.cuda.synchronize()
    log("profile", f"host batch preparation alone: "
        f"{(time.perf_counter() - t0) * 1e3 / N_BATCHES:.3f} ms per batch")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        import prefhetch_tpu_torch
    except ImportError:
        print("chip_smoke: the prefhetch_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    pkg_dir = os.path.dirname(os.path.abspath(prefhetch_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        print(f"chip_smoke: prefhetch_tpu_torch comes from {pkg_dir}, not "
              f"from this checkout", file=sys.stderr)
        return 2

    import numpy as np

    from prefhetch_tpu_torch.data.io import write_fvecs
    from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
    from prefhetch_tpu_torch.engine.server import QueryEngine
    from prefhetch_tpu_torch.metrics import benchmark_results
    from prefhetch_tpu_torch.ops import union_scan_min as usm
    from prefhetch_tpu_torch.ops.distances import rank_centroids
    from prefhetch_tpu_torch.ops.topk import topk_smallest
    from prefhetch_tpu_torch.serve.handlers import Dispatcher
    from prefhetch_tpu_torch.utils import cuda_build, wire_bin
    from prefhetch_tpu_torch.utils.config import SIFT1M_PRESET

    t_start = time.perf_counter()

    # -- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("card", f"nvidia-smi: {smi}")
    log("card", f"torch: {kind}, devices: {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda:0")

    # -- 2. build -----------------------------------------------------------
    kernels = ["union_scan_min"]
    for name in kernels:                  # always compile from the sources
        cuda_build.library_path(name).unlink(missing_ok=True)
    built = cuda_build.build(kernels)
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{name}: {info['seconds']:.2f} s; "
            + " | ".join(ptxas))

    # -- 3. kernels at edge shapes -----------------------------------------
    phase_edges()

    # -- 4. main path at the SIFT1M preset ----------------------------------
    t0 = time.perf_counter()
    data = make_clustered_dataset(
        nbase=NBASE, ntrain=NTRAIN, nquery=NQ_BATCH * N_BATCHES, d=D,
        n_clusters=600, gt_k=100, seed=20,
    )
    log("main", f"dataset {NBASE}x{D} + {NTRAIN} train + "
        f"{NQ_BATCH * N_BATCHES} queries with exact ground truth: "
        f"{time.perf_counter() - t0:.1f} s")
    work = os.path.join(ROOT, "prefhetch_tpu_torch", "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        paths = {k: os.path.join(work, f"smoke_{k}.fvecs")
                 for k in ("learn", "base")}
        write_fvecs(paths["learn"], data["train"])
        write_fvecs(paths["base"], data["base"])
        cfg = dataclasses.replace(
            SIFT1M_PRESET, train_path=paths["learn"], base_path=paths["base"]
        )
        engine = QueryEngine(cfg, index_dir=work, device="cuda")
        t0 = time.perf_counter()
        engine.init_index()               # cold path: train, add, save
        torch.cuda.synchronize()
        view = engine._tiled_view
        log("main", f"index built on the card and saved: "
            f"{time.perf_counter() - t0:.1f} s; lmax={engine.index.lmax}, "
            f"tiles={view.empty_tile} of T={view.tile}, payload "
            f"{view.payload.numel() * view.payload.element_size() / 1e9:.3f}"
            f" GB {view.payload.dtype}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    disp = Dispatcher(engine)
    status, _, body = disp.handle("GET", "/query", {}, b"")
    if status != 200:
        raise AssertionError(f"GET /query: {status} {body[:200]!r}")
    cents = torch.tensor(json.loads(body), dtype=torch.float32, device=dev)
    queries = data["query"].astype(np.float32)
    _, probes = rank_centroids(torch.from_numpy(queries).to(dev), cents,
                               cfg.protocol.nprobe)
    probes = probes.cpu().numpy().astype(np.int64)

    # kernel vs plain at the shapes of the first batch
    tile_idx, q1, union1, pos1, _ = engine._tiled_batch_prep(
        probes[:NQ_BATCH], queries[:NQ_BATCH]
    )
    max_err = check_union_scan_min(
        "main/batch0", view.payload, view.norms, view.sizes, q1, union1,
        min_atol=4.0,
    )
    j = engine._serve_prune_j(tile_idx.shape[1])
    if j == 0:
        raise AssertionError("tile pruning is off at the main-path shape")
    d2k, mink = usm.union_scan_min(view.payload, view.norms, view.sizes,
                                   q1, union1)
    d2r, minr = usm.union_scan_min_reference(view.payload, view.norms,
                                             view.sizes, q1, union1)
    U1 = union1.shape[0]
    tm_k = torch.gather(mink.reshape(U1, -1).T, 1, pos1.long())
    tm_r = torch.gather(minr.reshape(U1, -1).T, 1, pos1.long())
    sel_k = topk_smallest(tm_k, j)[1].cpu().numpy()
    sel_r = topk_smallest(tm_r, j)[1].cpu().numpy()
    tm_r_np = tm_r.cpu().numpy()
    n_diff = 0
    for qi in range(sel_k.shape[0]):
        a, b = set(sel_k[qi].tolist()), set(sel_r[qi].tolist())
        if a != b:
            # only a tie at the j-th minimum (within the min tolerance)
            # may swap which of two tiles is kept
            kth = np.sort(tm_r_np[qi])[j - 1]
            for s in a ^ b:
                if abs(tm_r_np[qi, s] - kth) > 4.0 + 1e-5 * abs(kth):
                    raise AssertionError(
                        f"kept tiles differ for query {qi} beyond a tie"
                    )
            n_diff += 1
    log("kernel", f"main/batch0: kept tiles (j={j}) equal as sets for "
        f"{sel_k.shape[0] - n_diff}/{sel_k.shape[0]} queries (the rest "
        f"differ only by a tie at the j-th minimum)")
    del d2k, d2r, mink, minr

    # the main path itself, with launch counts read around it only
    usm.union_scan_min.launches = 0
    usm.union_scan_min_reference.calls = 0
    ids_all, dists_all, req_ms = [], [], []
    k = cfg.protocol.k
    for b in range(N_BATCHES):
        sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
        req = wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
            queries[sl], probes[sl], np.array([k], np.uint32),
        ])
        t0 = time.perf_counter()
        status, ctype, body = disp.handle(
            "POST", "/search", {"content-type": wire_bin.CONTENT_TYPE}, req
        )
        req_ms.append((time.perf_counter() - t0) * 1e3)
        if status != 200:
            raise AssertionError(f"POST /search: {status} {body[:300]!r}")
        kind_r, (ids, dists) = wire_bin.decode(body)
        if kind_r != wire_bin.KIND_SEARCH:
            raise AssertionError(f"POST /search answered kind {kind_r}")
        ids_all.append(ids)
        dists_all.append(dists)
    launches = {"union_scan_min": usm.union_scan_min.launches}
    plain_calls = usm.union_scan_min_reference.calls
    log("main", f"POST /search x{N_BATCHES} of {NQ_BATCH} queries: "
        f"{', '.join(f'{t:.1f}' for t in req_ms)} ms (host clock, first "
        f"request includes warm-up); launches {launches}, plain-version "
        f"calls {plain_calls}")
    if launches["union_scan_min"] < N_BATCHES:
        raise AssertionError("K1 did not run on every /search request")
    if plain_calls != 0:
        raise AssertionError("the plain version ran on the main path")

    ids = np.concatenate(ids_all)
    dists = np.concatenate(dists_all)
    nq_all = NQ_BATCH * N_BATCHES
    if ids.shape != (nq_all, k) or dists.shape != (nq_all, k):
        raise AssertionError(f"bad result shapes {ids.shape} {dists.shape}")
    if not np.isfinite(dists).all() or (np.diff(dists, axis=1) < 0).any():
        raise AssertionError("distances not finite and ascending")
    if ids.min() < 0 or ids.max() >= NBASE:
        raise AssertionError("ids out of range")
    # the returned distances are the exact distances of the returned ids
    # (float64 on the card as the independent yardstick; SIFT-style
    # integer data makes the f32 re-rank exact)
    base64 = torch.from_numpy(data["base"]).to(dev, torch.float64)
    q64 = torch.from_numpy(queries).to(dev, torch.float64)
    exact = ((base64[torch.from_numpy(ids).to(dev)] - q64[:, None]) ** 2
             ).sum(-1).cpu().numpy()
    np.testing.assert_allclose(dists, exact, rtol=1e-6, atol=1e-3)
    rep = benchmark_results(ids, data["groundtruth"], k=k)
    log("main", f"recall@1 {rep.recall_1} recall@10 {rep.recall_10} "
        f"recall@100 {rep.recall_100} mrr@10 {rep.mrr_10}")
    if rep.recall_10 < RECALL10_MIN or rep.recall_100 < RECALL100_MIN:
        raise AssertionError(
            f"recall@10 {rep.recall_10} / recall@100 {rep.recall_100} "
            f"below {RECALL10_MIN} / {RECALL100_MIN}"
        )
    del base64, q64

    # -- 5. timings at the main-path shape (first batch) ---------------------
    args = (view.payload, view.norms, view.sizes, q1, union1)
    ms = cuda_time_ms(lambda: usm.union_scan_min(*args))
    plain_ms = cuda_time_ms(lambda: usm.union_scan_min_reference(*args))
    ms2 = cuda_time_ms(lambda: usm.union_scan_min(*args))
    # library yardstick: one torch.matmul of the bf16 cross term alone
    # [nq, d] x [d, U_real*T] — a part of K1's function, not all of it
    sizes_u = view.sizes[union1.long()]
    real = union1[sizes_u > 0].long()
    slab_t = view.payload[real].reshape(-1, D).T.contiguous()
    qc = q1.to(view.payload.dtype)
    library_ms = cuda_time_ms(lambda: torch.matmul(qc, slab_t))
    del slab_t
    # the card's bound for the same work: each input byte read once (the
    # valid payload rows and norms of the union tiles), each output byte
    # written once; the product's FLOPs over the valid rows
    nq1, T = q1.shape[0], view.tile
    rows = int(sizes_u.sum())
    esz = view.payload.element_size()
    bytes_moved = (rows * D * esz + rows * 4 + U1 * 4 + U1 * 4
                   + nq1 * D * esz + nq1 * 4
                   + U1 * nq1 * T * 2 + U1 * nq1 * 4)
    flops = 2.0 * nq1 * D * rows
    bound_ms = max(bytes_moved / HBM_BYTES_S, flops / BF16_FLOPS) * 1e3
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_S >= flops / BF16_FLOPS
                else "operations")
    log("timing", f"union_scan_min at U={U1} (real tiles {len(real)}, "
        f"valid rows {rows}) nq={nq1} T={T} d={D}: kernel {ms:.4f} / "
        f"{ms2:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul cross term "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    profile_search(disp, queries, probes, k)
    log("done", f"wall {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "union_scan_min",
        "route": "cuda",
        "source": "prefhetch_tpu_torch/csrc/union_scan_min.cu",
        "replaces": "prefhetch_tpu/ops/pallas_scan.py:256",
        "launches": launches["union_scan_min"],
        "launches_per_batch": launches["union_scan_min"] / N_BATCHES,
        "max_abs_err": max_err,
        "ms": min(ms, ms2),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "torch.matmul bf16 [nq,d]x[d,U_real*T], the cross "
                        "term only (a partial function)",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
