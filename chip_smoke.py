#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (prefhetch_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Phases, each
reporting on lines of its own; any failure exits non-zero:

1. card     — the card's name and power limit (nvidia-smi) and torch's name;
2. build    — compiles every kernel of the port from csrc/ with nvcc (and
              the host C++ libraries, native/*.cpp: the host NTT and vecs
              reader, the JSON codec and the epoll frontend, with g++
              beside them), and
              checks that K1's and K2's machine code multiply on the tensor
              cores (HMMA or HGMMA for K1's bf16, IMMA for K2's int8 digit
              products, in cuobjdump -sass);
3. edges    — K1 against its plain PyTorch version on the card at edge
              shapes (size-0 and partial tiles, nq not a multiple of the
              query block, two query blocks, an f32 payload, bf16 at d=40
              and d=200 where K is not a multiple of 16);
   variant edges — K5, K4 (slab distances over a dense and an SQ8 payload)
              and K3 (PQ table lookups over each query's probed tiles, the
              scalar, clamp and mask fused) against their plain versions at
              edge shapes (tiles of size T, 1, T-1, 0, a probe row of
              nothing but the empty tile, one probe slot, byte-wise code
              loads, M=200, ksub=64, a zero list table, nq=1 and 70; for
              the tile-major K4 and K5, at bf16 and f32, also a tile probed
              by all 64 queries, a query probing one tile twice and nothing
              but size-0 tiles); the tile schedule of K4 and K5 bit-equal
              to torch.sort(stable=True) on every edge's probe ids, past
              32,768 tiles (int32 keys) and past the 6,144 pairs it stages
              in shared memory, its piece list equal to the plain one;
   ntt      — K2 (the whole four-step NTT in one launch) against its plain
              version (two plain stages) and the host butterfly NTT: exact
              equality, forward and inverse, N=4096 (64x64) and N=8192
              (64x128), B in {1, 33, 512}, canonical, lazy, all-(q-1) and
              near-2^31 inputs, int32 and int64;
   native   — the host NTT (native/host_lib.cpp, under every host
              transform) bit-equal to the numpy butterfly at every prime of
              the HEParams defaults and PIR (N=4096) and config 3 (N=8192),
              forward and inverse, canonical, negative and >= q inputs; the
              vecs reader bit-equal to numpy on a generated fvecs and ivecs
              file; host-clock times of the butterfly and the native
              transform at [1, 4096], [128, 4096] and [2048, 8192], and of
              the library with its negative-input lift taken out, in turns;
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
   encrypted — the BFV encrypted re-rank on the same index and base, HE
              defaults (N=4096, 2 limbs, t=2^24), 256 candidates per query:
              binary POST /coarsesearch top-256, then POST /encryptedsearch
              for the same 4 batches of 64 queries (3 with respMod "full",
              1 with "q1" and a sparse key), client decrypt, top-100. K2 is
              first held against its plain version at the first batch's own
              transform inputs, and the device program against its numpy
              twin;
              launch counts are read around the requests only; decrypted
              distances must equal the plaintext precise_search scores
              exactly; recall as above; then where one request's time goes;
   scores   — BFV whole-ciphertext per-block scores on the same service,
              the first batch's 64 queries and 256 candidates: the client
              encrypts, HEComputeService.encrypted_scores_batch runs on the
              card (one K2 launch a limb over the 512 (query, block) rows),
              HEClient.decrypt_scores_batch decrypts; distances equal
              precise_search exactly, the result ciphertexts bit-equal to
              _mac_numpy on every query, one query's encrypted_scores its
              row of the batch (8 blocks, 2 launches); K2 against its plain
              version at [512, 4096] and [8, 4096]; the stages (pack,
              upload, device program, download) and the client's on the
              host clock;
   packed   — the packed BFV response (respMod "packed", seedTf queries:
              the c1 mask regenerated on the card) on the same candidates:
              HEClient(resp_mod="packed"), K2 against its plain version at
              the packed program's primes and row counts, the device
              program bit-equal to its numpy twin on the first batch's
              first G queries, then N_BATCHES requests of 64 queries (the
              first carries the Galois keys) with K2's launches counted
              around each (52) and the key switch's kernels' (35: digits,
              three macs and the finish a round), decrypted distances
              equal to precise_search, the key switch's kernels bit-equal
              to their plain versions at the last round and timed,
              recall equal to the encrypted path's, the stage breakdown of
              one request with its bytes, and its device time by kernel;
   ckks     — CKKS slot-packed encrypted scoring at BASELINE.json config 3
              (N=8192, 3 limbs, scale 2^26) on the same engine, index, base
              and candidates, the engine's CKKS service built from those
              parameters: K2 against its plain version at the program's
              four primes and at [2048, 8192] and [128, 8192]; the device
              program (host encode) bit-equal to its numpy twin
              (CKKSComputeService) on the first query, the served gather
              form bit-equal to the row-upload device encode on the first
              batch, and its error the size of the host encode's; then
              N_BATCHES combined requests of 64 seedTf queries (the first
              carrying the 10 Galois keys) and one per-block request of 8
              queries, with K2's launches counted around each (56 and 48);
              the per-block distances within 0.01 of the largest distance
              (bench.py's ckks_max_rel_err) and at the recall limits; the
              combined ones within their own precision (2^17 absolute),
              their relative error on the coarse candidates and on
              bench.py's workload and their recall reported; the stage
              breakdown of one request with its bytes, and its device time
              by kernel;
   pir      — private row retrieval on the same engine and base (HE
              defaults: N=4096, 2 limbs, t=257): the engine's DevicePIR2
              built on the card (pack_database on the host, the 1,026.7 MB
              database transformed by K2, 2 launches, held against its
              plain version on the build's own input), the device program
              bit-equal to the numpy
              PIR2Server at nbase 5,000; then one POST /pir-fetch of 4
              single-row queries (62 K2 launches) and the client's stage 8
              on the first /search query's top-100 through the multi-row
              wire (10 cts of 11 rows, a 12-level expansion, 80 launches),
              every row exact, with the shape of each K2 launch recorded;
              K2 against its plain version at every shape recorded (up to
              [163,840, 4,096] int32 forward and [81,920, 4,096] int32
              inverse, the multi-row key switch's last round); one launch
              of the dim-1 fold's kernel (csrc/pir_fold1.cu) a program,
              five of the key switch's kernels (csrc/key_switch.cu) a
              round of the expansion (60 a 12-level program, counted as
              he.ks.launches on its expansion stage), no plain call; those
              kernels at the widest round (M = 40,960) bit-equal to their
              plain versions and timed beside their byte bounds; the warm
              request's program peak beside PR 25's; where one multi-row request's time goes, the
              fold's kernel beside its plain version at S = 4 and 110
              (bit-equal) with its byte and multiply-add bounds, the
              device's busy share and K2's time at that widest round;
   http     — the reference's protocol served over HTTP on the same engine
              by the native epoll frontend, in-process (max_batch 256,
              grace 1.5 ms, 3 resolvers; /stats must report it): the port's
              ClientPipeline runs stages 2-8 on 64 queries (GET /query, JSON
              /coarsesearch of every candidate in the probed lists,
              /precisesearch, /precise-vector-pir), its final ids equal to
              the same stages run in-process, precise distances the float64
              ones, vectors base[ids] bit for bit, recall above the limits;
              the binary wire (GET /tiletable, the tiled q16 coarse kind,
              client selection, binary /precisesearch) on the same queries;
              64 threads x 20 one-query binary /search requests, every
              answer equal to the single-request answer, K1 launched once
              per engine call of the waves, q/s, p50 and p99 on one line
              with the card's name and power limit; one "full", one
              "packed" and one CKKS combined /encryptedsearch request of
              stage 6 over HTTP, decrypted (BFV exactly, CKKS within its
              precision) with 4, 52 and 56 K2 launches; then the port's
              server (python -m
              prefhetch_tpu_torch.serve.main --frontend native, its index
              built on the card) and driver (python -m
              prefhetch_tpu_torch.client.driver) as two processes on a 100K
              SIFT-style dataset at the preset's widths, the client
              driver's timing line and recall/MRR block required, the
              server killed by PID; then the same with serve.main --shard
              (the index warm-loaded, then sharded over every visible
              card), the driver run twice against each server (first and
              warm requests), its recall/MRR block the unsharded server's;
   variants — the quantised and slab scan variants of the triage pipeline
              (pipeline.query_pipeline) on the same index and base:
              quant="pq" (PQ codes, 256-slot tiles, K3 over the probed
              tiles, no union), quant="sq8"
              (8-bit payload, K4) and scan="slab" (dense payload, K5); K4
              and K5 each after one launch of the tile schedule. For each:
              the tiled view, the schedule against torch.sort at the first
              batch's probe ids, the kernel against its plain version at
              the first batch's own shapes, its time (and the schedule's)
              beside the plain version, a library call and the card's
              bound, then the same 4 batches of 64 queries with every
              kernel's launch count read around them, exact returned
              distances and recall;
   entry    — the dense-layout path, which runs no hand-written kernel
              (XLA in the JAX package): entry.entry() at its own shape (the
              JAX entry's contract, and the same query_step on the same
              tensors on the CPU: ids equal where distances do not tie,
              distances to rtol 1e-5); query_step at the preset (nprobe
              16, COARSE_PROBE 256, K 100) over the engine's bf16
              list_recon for the same 4 batches (recall limits, exact
              float64 distances); the models' search at the same point:
              IVFPQ on list_recon (its ids the step's top-256 cut to 100,
              as sets, where distances do not tie) and on its PQ codes
              alone (the LUT scan within bf16 rounding of the list_recon
              scan; its ADC recall printed), FlatL2 (recall 1.0), IVFFlat
              and IVFSQ8 assembled from the engine's own lists (exact and
              decoded-vector distances; SQ8 recall@100 within 0.02 of
              IVFFlat's); the engine's dense coarse branch (no tiled view:
              an SQ8 index, then PQ codes alone) through JSON
              /coarsesearch, byte-equal to the model's masked scan; each
              search's host clock a batch, device time (torch.profiler)
              and byte bound with the card's name and power limit; no
              kernel launched in the phase;
5. timings  — each kernel's own device time at the main-path shape
              (torch.profiler; the CUDA-event time of a loop of wrapper
              calls beside it, which the host's pace can set for a fast
              kernel), beside its plain version, a PyTorch library call and
              the card's bound for the same work, and K1 alone at the
              bench headline's shape (the index in tiles of 1,024, the
              256 queries in one batch); printed as one JSON line
              {"kernels": [...]}; then torch.profiler over warm /search
              requests: device time by kernel and the device's busy share;
   ablation — K4, K5 and K2 rebuilt with one part taken out or one
              constant changed (tools/kernel_ablation.py), K4 timed on the
              first quant="sq8" batch's own inputs, K5 on the first
              scan="slab" batch's, K2 on the forward transform at the
              request's shape, each beside the unchanged source; the
              variants that change a constant are held against the plain
              version;
6. shard    — sharding (parallel/), last, since it leaves the main
              engine sharded: the unsharded engine's answers to GET /query
              and /tiletable and 4 x (POST /search, JSON, tiled and
              top-256 /coarsesearch, JSON /precisesearch, binary
              /precise-vector-pir); enable_sharding() over every visible card (a
              mesh of one), then over 4 shards of cuda:0, each answering
              the same requests byte for byte, K1 launched once a shard a
              /search batch and held against its plain version at every
              shard's union share, the card memory sharding adds (shards
              are views); sharded_trunc_mac_q1 on 64 queries x 256
              candidates over 1 and 4 shards, bit-equal to the one-device
              q1 program (6 K2 launches a shard) and decrypted exactly;
              DevicePIR2.answer_2d_sharded at the SIFT1M grid over 1 and 3
              shards, bit-equal to answer_2d, the row exact, a mesh of 4
              refused; K2 against its plain version at every shape those
              launched; init_multihost as an NCCL world of one; the dry run
              dryrun_multichip(4) on cuda:0; times with their clock beside
              them; then the host stages that run host NTTs (ct_from_wire,
              the CKKS first request and client encryption, the PIR
              client's decoding), as the phases above timed them on the
              native transform, each beside its figure on the butterfly;
7. bench    — the benchmark entry point, python -m
              prefhetch_tpu_torch.bench's main, in two processes at once
              (each this script run as a bench child, its cache under
              prefhetch_tpu_torch/build/bench_cache/, kept between runs):
              at the full SIFT1M point the sections no earlier phase drives
              (the headline with its numpy baseline, angular and hard,
              three 1M datasets and indexes), and at PFH_BENCH_NBASE=100000
              the headline with encrypted (and its HTTP wire), http (256
              closed-loop clients), ckks, pq and pir; each must exit 0 with
              one line holding every section's keys, no error and only the
              sections left out skipped; from the bench's stderr, K1
              launched in core, angular and hard, K3 in pq, K2 in
              encrypted, ckks and pir, and no plain version anywhere; in
              each section K1's first and widest launch and K3's first
              held against their plain versions on those launches' inputs,
              K2's first launch on its input and K2 at every shape the
              section gave it; the headline's recall at the limits above,
              hard's under its exact-IVF oracle, the encrypted distances
              over HTTP exact, CKKS within the bench's CKKS_MAX_REL; the
              figures (two runs sharing the card: not measurements) and
              each section's seconds printed; the kernels line gains each
              kernel's launches and checks there;
8. result   — the last line, {"ok": true, "device": {...}}.

Without CUDA, or without the port beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# FLOP/s, f32 FLOP/s, dense int8 OP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12                # outside the tensor cores
INT8_OPS = 1979e12
# int8 multiply-adds that one multiply-add of two 30-bit residues costs on
# the int8 tensor cores: 4 x 4 balanced base-256 digits
INT8_MACS_PER_MODMAC = 16
# 32-bit by 32-bit multiply-adds into 64 bits (IMAD.WIDE.U32) a second:
# 132 SMs x ~16 a clock x the 1,980 MHz boost clock, an estimate (the data
# sheet gives no integer rate; the dim-1 fold's loop without its loads ran
# at 3.3 T a second on an H100 80GB HBM3 at 700 W)
MAD_WIDE_S = 132 * 16 * 1.98e9

NBASE, NTRAIN, D = 1_000_000, 100_000, 128
NQ_BATCH, N_BATCHES = 64, 4
RECALL10_MIN, RECALL100_MIN = 0.95, 0.85
CKKS_MAX_REL = 0.01             # bench.py's ckks_max_rel_err, config 3
# the combined CKKS response's own precision at config 3 (the reference
# arithmetic, bit-equal to the JAX package's): a rescale at scale 2^22 of
# messages of ~1, read at a final scale of 2^5, leaves distance errors of
# a few thousand whatever the distances, their spread set by the client's
# keys (tools/ckks_noise.py: over 8 keys on SIFT-style candidates, std
# 1.7e3-4.1e3, the largest of 64 x 256 errors 6.7e3-2.6e4). A wrong slot,
# key or rotation errs by the order of the inner products (~1e6).
CKKS_COMBINED_MAX_ABS = 2.0 ** 17
Q1_SPARSE_H = 32                # sparse secret for the "q1" response wire
# host stages that run host NTTs, re-timed by the phases on the native
# transform, beside their figures on the numpy butterfly (PERF.md § 5,
# earlier runs of this script, NVIDIA H100 80GB HBM3, 700.00 W)
BUTTERFLY_FIGURES = {
    "ct_from_wire in a 64-query full request": "136.6 ms",
    "CKKS first combined request with its keys": "1,011.7 ms",
    "CKKS client encrypting 64 queries": "1.4-1.7 s",
    "PIR client decoding 100 rows": "2,092 ms",
}
HOST_STAGES: dict = {}


# where log writes: stdout, or stderr in a bench child (its stdout is the
# bench's line)
LOG_TO = None


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", file=LOG_TO, flush=True)


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


def device_ms(fn, kernel=None, iters: int = 20, warmup: int = 3,
              tries: int = 3):
    """Device time in ms from torch.profiler over iters calls of fn(): with
    ``kernel``, the mean time of one launch of the kernels whose name holds
    it (the kernel's own time on the card, whatever the host's pace between
    launches); without, all device work per call. The profiler at times
    drops a window's kernel records, so up to ``tries`` windows are
    profiled. None when none of them recorded such a device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if ev.device_type == DeviceType.CUDA and us > 0 and (
                    kernel is None or kernel in ev.key):
                total_us += us
                count += ev.count
        if count:
            return total_us / 1e3 / (count if kernel is not None else iters)
    return None


def kernel_ms(fn, kernel: str, events_ms: float) -> float:
    """A kernel's time for the kernels line: its device time from the
    profiler, or the CUDA-event time of the wrapper loop where the profiler
    saw no device event."""
    dev = device_ms(fn, kernel)
    return events_ms if dev is None else dev


def k1_bound(payload, sizes, union, nq: int):
    """The card's bound for K1's work on a union: each input byte read once
    (the valid payload rows and norms of the union tiles), each output byte
    written once; the product's FLOPs over the valid rows → (bound_ms,
    bound_by, bytes, flops, valid rows)."""
    U, T, d = union.shape[0], payload.shape[1], payload.shape[2]
    rows = int(sizes[union.long()].sum())
    esz = payload.element_size()
    bytes_moved = (rows * d * esz + rows * 4 + U * 4 + U * 4
                   + nq * d * esz + nq * 4 + U * nq * T * 2 + U * nq * 4)
    flops = 2.0 * nq * d * rows
    bound_ms = max(bytes_moved / HBM_BYTES_S, flops / BF16_FLOPS) * 1e3
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_S >= flops / BF16_FLOPS
                else "operations")
    return bound_ms, bound_by, bytes_moved, flops, rows


def check_union_scan_min(name, payload, norms, sizes, q, union,
                         min_atol: float, d2_atol: float = 0.5) -> float:
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
    torch.testing.assert_close(d2k[ok], d2r[ok], rtol=1e-2, atol=d2_atol)
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
    # bf16 on the tensor cores with K not a multiple of 16: d = 40 (one
    # zero-filled feature chunk) and d = 200 (four chunks, T % 8 != 0)
    case("edge/bf16,d=40", 4, 512, 40, 64, torch.bfloat16,
         [512, 37, 0, 300, 0], [0, 1, 2, 3, 4, 4])
    case("edge/bf16,d=200,T=100", 3, 100, 200, 5, torch.bfloat16,
         [100, 1, 64, 0], [2, 0, 1, 3])
    # two query blocks
    case("edge/bf16,nq=128", 4, 256, 128, 128, torch.bfloat16,
         [256, 37, 0, 200, 0], [0, 1, 2, 3, 4, 4])


def check_tensor_core_sass(path, ops, kernel: str) -> None:
    """A kernel's library must multiply on the tensor cores: its machine
    code (cuobjdump -sass, from the toolkit beside nvcc) holds one of
    ``ops`` (HMMA/HGMMA for K1's bf16 mma.sync/wgmma, IMMA for K2's int8)."""
    from prefhetch_tpu_torch.utils import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {op: sum(1 for ln in sass.splitlines() if f" {op}." in ln)
              for op in ops}
    if not any(counts.values()):
        raise AssertionError(f"{path.name}: none of {ops} in its SASS: "
                             f"{kernel} does not use the tensor cores")
    log("build", f"{path.name}: tensor-core instructions in the SASS: "
        f"{counts}")


def check_transform(name, x, tb, inverse, got=None) -> int:
    """K2 (one launch) against its plain version (two plain stages) on the
    same card tensor: equal, canonical. ``got``, where given, is K2's
    output on x from a launch the caller made. The plain version runs over
    slices of at most 2^26 elements (16,384 rows at N=4096; its float64
    stages take ~40 bytes an element). Returns the max |difference| (0)."""
    import torch

    from prefhetch_tpu_torch.ops import ntt4 as n4
    from prefhetch_tpu_torch.ops import ntt4_fused as k2

    if got is None:
        before = k2.ntt4_transform.launches
        got = (n4.intt4 if inverse else n4.ntt4)(x, tb)
        torch.cuda.synchronize()          # a fault in the run shows here
        if k2.ntt4_transform.launches != before + 1:
            raise AssertionError(f"{name}: not one K2 launch")
    if got.dtype != torch.int32 or got.shape != x.shape \
            or int(got.min()) < 0 or int(got.max()) >= tb.q:
        raise AssertionError(f"{name}: output not canonical int32 [B, N]")
    err, step = 0, max(1, (1 << 26) // tb.n)
    for i in range(0, x.shape[0], step):
        want = n4.transform_plain(x[i:i + step], tb, inverse)
        err = max(err, int((got[i:i + step].long() - want.long()).abs()
                           .max()))
    if err != 0:
        raise AssertionError(f"{name}: K2 differs from its plain version "
                             f"(max |diff| {err})")
    return err


@contextlib.contextmanager
def recording_k2(keep_inputs: bool = False):
    """Records every K2 launch that ops/ntt4's ntt4/intt4 make inside the
    block, as (rows, dtype, inverse, tables, the input where
    ``keep_inputs``). It wraps the name ops/ntt4 calls, not the counted
    wrapper, so the kernel's launch count is untouched."""
    from prefhetch_tpu_torch.ops import ntt4 as n4

    seen = []
    real = n4.ntt4_transform

    def record(x, tb, inverse):
        seen.append((x.shape[0], x.dtype, bool(inverse), tb,
                     x if keep_inputs else None))
        return real(x, tb, inverse)

    n4.ntt4_transform = record
    try:
        yield seen
    finally:
        n4.ntt4_transform = real


def phase_ntt() -> None:
    """K2, the whole transform in one launch, against its plain version and
    the host butterfly NTT, all exact: forward and inverse, int32 and int64
    inputs, canonical, lazy, all-(q-1) and near-2^31 values."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.crypto import ntt as hostntt
    from prefhetch_tpu_torch.crypto.params import find_ntt_primes
    from prefhetch_tpu_torch.ops import ntt4 as n4

    for n in (4096, 8192):
        q = find_ntt_primes(n, 30, 2)[1]
        tb = n4.build_ntt4_tables(q, n)
        perm, inv_perm = n4.fourstep_perm(tb)
        host_tb = hostntt.build_tables(q, n)
        for bsz in (1, 33, 512):
            for kind in ("canonical", "lazy", "all q-1", "near 2^31"):
                rng = np.random.default_rng(n + bsz + len(kind))
                if kind == "canonical":
                    x = rng.integers(0, q, (bsz, n), dtype=np.int64)
                elif kind == "lazy":
                    x = rng.integers(0, 1 << 31, (bsz, n), dtype=np.int64)
                elif kind == "all q-1":
                    x = np.full((bsz, n), q - 1, np.int64)
                else:
                    x = (1 << 31) - 1 - rng.integers(0, 1 << 20, (bsz, n),
                                                     dtype=np.int64)
                x[0, :4] = [0, q - 1, q, (1 << 31) - 1]
                for dtype in (torch.int32, torch.int64):
                    xc = torch.from_numpy(x).to("cuda", dtype)
                    tag = f"n={n} B={bsz} {kind} {dtype}"
                    check_transform(f"ntt4 {tag}", xc, tb, False)
                    check_transform(f"intt4 {tag}", xc, tb, True)
                fwd = n4.ntt4(xc, tb)
                host = hostntt.ntt_plain(x % q, host_tb)
                if not np.array_equal(fwd.cpu().numpy(), host[:, perm]):
                    raise AssertionError(f"ntt4 n={n} B={bsz} {kind}: differs "
                                         f"from the host butterfly NTT")
                inv = n4.intt4(xc, tb)
                host_inv = hostntt.intt_plain((x % q)[:, inv_perm],
                                              host_tb)
                if not np.array_equal(inv.cpu().numpy(), host_inv):
                    raise AssertionError(f"intt4 n={n} B={bsz} {kind}: "
                                         f"differs from the host butterfly")
                back = n4.intt4(fwd.long(), tb)
                if not np.array_equal(back.cpu().numpy(), x % q):
                    raise AssertionError(f"n={n} B={bsz} {kind}: inverse of "
                                         f"forward is not the input")
        log("ntt", f"N={n} ({tb.n1}x{tb.n2}) q={q}: K2 = plain = host "
            f"butterfly, forward and inverse, B in (1, 33, 512), canonical, "
            f"lazy, all-(q-1) and near-2^31 inputs, int32 and int64: ok "
            f"(max |err| 0)")


def host_ntt_primes() -> dict:
    """{N: primes} of the parameter sets whose host transforms the served
    paths and clients run: the HEParams defaults (BFV N=4096, 2 limbs, the
    packed key switch's special prime) and PIR at N=4096, config 3 (CKKS
    N=8192, 3 limbs and its special prime) at N=8192."""
    from prefhetch_tpu_torch.crypto.bfv import BFVContext
    from prefhetch_tpu_torch.crypto.params import (
        bfv_params_for, find_ntt_primes, pir_params_for,
    )

    p4 = set()
    for p in (bfv_params_for(4096, 24, 2), pir_params_for(4096, 257, 2)):
        p4 |= set(p.qs) | {BFVContext(p)._special_p}
    return {4096: sorted(p4), 8192: find_ntt_primes(8192, 30, 4)}


def host_ms(fn, reps: int) -> float:
    """Least host-clock ms of ``reps`` calls of fn()."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def build_host_lib_without_lift(work: str):
    """The host library rebuilt with the negative-input lift taken out
    (every value read as its uint64 bit pattern, as the JAX package's copy
    reads it), bound for pfh_ntt_batch: what the lift costs on canonical
    input, where both give the same transform."""
    import ctypes

    from prefhetch_tpu_torch import native

    src = (native.SRC / f"{native.HOST}.cpp").read_text()
    body = "return (uint64_t)v + (v < 0 ? up : 0);"
    if src.count(body) != 1:
        raise AssertionError("host_lib.cpp: the lift to take out is not "
                             "where the smoke expects it")
    path = os.path.join(work, "host_lib_nolift.cpp")
    with open(path, "w") as f:
        f.write(src.replace(body, "(void)up; return (uint64_t)v;"))
    so = os.path.join(work, "libhost_lib_nolift.so")
    subprocess.run(["g++", *native.CXX_FLAGS, path, "-o", so], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    native._bind_host(lib)
    return lib


def phase_native(smi: str) -> None:
    """The port's host C++ library (native/host_lib.cpp): the Shoup NTT
    bit-equal to the numpy butterfly at every prime of the served parameter
    sets, N=4096 and 8192, forward and inverse, on canonical, negative and
    >= q inputs; the vecs reader bit-equal to numpy on a generated file;
    host-clock times of the butterfly and the native transform at the
    shapes the paths run, and of the lift of negative inputs against the
    same library without it."""
    import numpy as np

    from prefhetch_tpu_torch import native
    from prefhetch_tpu_torch.crypto import ntt as hostntt
    from prefhetch_tpu_torch.data.io import (
        read_fvecs, read_ivecs, write_fvecs, write_ivecs,
    )

    n_checked = 0
    for n, primes in host_ntt_primes().items():
        for q in primes:
            tb = hostntt.build_tables(q, n)
            rng = np.random.default_rng(q % 1009)
            for kind, x in (
                    ("canonical", rng.integers(0, q, (16, n))),
                    ("negative", rng.integers(-4 * q, 0, (16, n))),
                    (">= q", rng.integers(q, 8 * q, (16, n)))):
                for inverse in (False, True):
                    got = (hostntt.intt if inverse else hostntt.ntt)(x, tb)
                    want = (hostntt.intt_plain if inverse
                            else hostntt.ntt_plain)(x, tb)
                    if not np.array_equal(got, want):
                        raise AssertionError(
                            f"native {'inverse' if inverse else 'forward'} "
                            f"NTT N={n} q={q} {kind}: differs from the "
                            f"butterfly")
                    n_checked += 1
        log("native", f"N={n}, primes {primes}: native NTT = butterfly, "
            f"forward and inverse, canonical, negative and >= q inputs "
            f"(16 rows each): ok (bit-equal)")

    work = os.path.join(ROOT, "prefhetch_tpu_torch", "build", "smoke_native")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        rng = np.random.default_rng(12)
        xf = rng.integers(0, 256, (100_000, 128)).astype(np.float32)
        xi = rng.integers(0, 1_000_000, (10_000, 100)).astype(np.int32)
        pf, pi = os.path.join(work, "x.fvecs"), os.path.join(work, "x.ivecs")
        write_fvecs(pf, xf)
        write_ivecs(pi, xi)
        for path, arr, read, dt in ((pf, xf, read_fvecs, np.float32),
                                    (pi, xi, read_ivecs, np.int32)):
            rows = np.fromfile(path, "<i4").reshape(arr.shape[0], -1)
            want = rows[:, 1:].copy().view(dt)
            got = read(path)
            if not (np.array_equal(got, want) and np.array_equal(got, arr)
                    and got.dtype == dt):
                raise AssertionError(f"{path}: the native reader differs "
                                     f"from numpy")
        t_nat = host_ms(lambda: read_fvecs(pf), 3)
        t_np = host_ms(lambda: np.fromfile(pf, "<i4").reshape(
            100_000, 129)[:, 1:].copy().view(np.float32), 3)
        log("native", f"vecs reader: fvecs [100,000, 128] and ivecs "
            f"[10,000, 100] bit-equal to numpy; fvecs read {t_nat:.2f} ms "
            f"native, {t_np:.2f} ms numpy (host clock, least of 3)")

        nolift = build_host_lib_without_lift(work)
        q4, q8 = host_ntt_primes()[4096][0], host_ntt_primes()[8192][0]
        for rows_n, n, q in ((1, 4096, q4), (NQ_BATCH * 2, 4096, q4),
                             (2048, 8192, q8)):
            tb = hostntt.build_tables(q, n)
            x = np.random.default_rng(rows_n).integers(0, q, (rows_n, n))
            fn = hostntt._native(tb, False)
            plain_reps = 1 if rows_n * n > 1 << 22 else 3
            t_plain = host_ms(lambda: hostntt.ntt_plain(x, tb), plain_reps)
            t_nat = host_ms(lambda: hostntt.ntt(x, tb), 5)
            t_inv = host_ms(lambda: hostntt.intt(x, tb), 5)
            t_inv_plain = host_ms(lambda: hostntt.intt_plain(x, tb),
                                  plain_reps)

            def without_lift():
                out = np.array(x, np.int64)
                nolift.pfh_ntt_batch(
                    native._ptr(out), rows_n, n, q, native._ptr(fn.psi),
                    native._ptr(fn.psi_sh), native._ptr(fn.tw),
                    native._ptr(fn.tw_sh), native._ptr(fn.bitrev), 1,
                    fn.n_threads)
                return out

            if not np.array_equal(without_lift(), hostntt.ntt(x, tb)):
                raise AssertionError("the library without the lift differs "
                                     "on canonical input")
            # in turns: with, without, without, with
            t_l1 = host_ms(lambda: hostntt.ntt(x, tb), 5)
            t_n1 = host_ms(without_lift, 5)
            t_n2 = host_ms(without_lift, 5)
            t_l2 = host_ms(lambda: hostntt.ntt(x, tb), 5)
            log("native", f"{smi}, host clock (the host NTT is host work): "
                f"[{rows_n}, {n}] q={q}: forward butterfly {t_plain:.3f} "
                f"ms, native {t_nat:.3f} ms ({t_plain / t_nat:.1f}x); inverse "
                f"butterfly {t_inv_plain:.3f} ms, native {t_inv:.3f} ms "
                f"({t_inv_plain / t_inv:.1f}x); the lift of negative "
                f"inputs: with {t_l1:.3f} / {t_l2:.3f} ms, without "
                f"{t_n1:.3f} / {t_n2:.3f} ms ({fn.n_threads} threads, least "
                f"of 5 each)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("native", f"{n_checked} transforms checked")


def check_k2_at_request_shape(svc, ctq, idx) -> int:
    """K2 against its plain version at the transform inputs of one real
    request (the lifted candidate polynomials, int32, then the int64 c0
    products), every limb. Returns the max |difference| (0)."""
    import torch

    from prefhetch_tpu_torch.ops.ntt4 import modmul, transform_plain

    n = svc.params.n
    nq = idx.shape[0]
    polys = svc._base_dev[idx.long()].flip(-1).reshape(-1, n)
    nb = polys.shape[0] // nq
    c0q = ctq[:, 0][..., svc._perm]
    err = 0
    for i, tb in enumerate(svc._tables):
        lifted = torch.where(polys < 0, polys + tb.q, polys)
        err = max(err, check_transform(f"req/ntt4 limb {i}", lifted, tb,
                                       False))
        pt = transform_plain(lifted, tb, False).reshape(nq, nb, n)
        o0 = modmul(c0q[:, None, i], pt, tb.q).reshape(-1, n)
        err = max(err, check_transform(f"req/intt4 limb {i}", o0, tb, True))
    log("kernel", f"ntt4_transform at the request's transform inputs "
        f"[{polys.shape[0]}, {n}] int32 (forward) and int64 (inverse) x "
        f"{len(svc._tables)} limbs: ok (max |err| {err})")
    return err


def post_coarse_topk(disp, queries, probes, k):
    import numpy as np

    from prefhetch_tpu_torch.utils import wire_bin

    req = wire_bin.encode(wire_bin.KIND_COARSE_TOPK_REQ, [
        queries, probes, np.array([k], np.uint32)])
    t0 = time.perf_counter()
    status, _, body = disp.handle(
        "POST", "/coarsesearch", {"content-type": wire_bin.CONTENT_TYPE}, req)
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"POST /coarsesearch: {status} {body[:300]!r}")
    kind, (ids, dists, counts) = wire_bin.decode(body)
    if kind != wire_bin.KIND_COARSE_TOPK or ids.shape != (len(queries), k):
        raise AssertionError(f"POST /coarsesearch answered kind {kind}, "
                             f"ids {ids.shape}")
    return ids, ms


def post_encrypted(disp, client, queries, cand, mode):
    """One /encryptedsearch request through the Dispatcher and the client's
    decryption. Returns (distances [nq, P] f32, request ms, bytes up/down,
    client encrypt ms, client decrypt ms)."""
    import numpy as np

    from prefhetch_tpu_torch.utils.wire import unpack_i32

    t0 = time.perf_counter()
    body = {"encryptedPreciseQuery": client.encrypt_query_batch(queries),
            "nearestCoarseVectorIndexes": cand.tolist()}
    if mode != "full":
        body["respMod"] = mode
    raw = json.dumps(body).encode()
    enc_ms = (time.perf_counter() - t0) * 1e3
    if b"preciseQuery" in raw:
        raise AssertionError("the plaintext query is in the request")
    t0 = time.perf_counter()
    status, _, resp = disp.handle("POST", "/encryptedsearch", {}, raw)
    req_ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"POST /encryptedsearch: {status} "
                             f"{resp[:300]!r}")
    t0 = time.perf_counter()
    out = json.loads(resp)
    norms = np.asarray(out["candidateNorms"])
    c0 = unpack_i32(out["c0Ip"])
    if mode == "full":
        dists = client.decrypt_scores_trunc(unpack_i32(out["c1Ntt"]), c0,
                                            norms, queries)
    else:
        dists = client.decrypt_scores_trunc_q1(unpack_i32(out["c1Q1"]), c0,
                                               norms, queries)
    dec_ms = (time.perf_counter() - t0) * 1e3
    return dists, req_ms, len(raw), len(resp), enc_ms, dec_ms


def encrypted_breakdown(disp, client, queries, cand, mode) -> dict:
    """Where one /encryptedsearch request's time goes: the stages of the
    served path itself (utils/stages.py marks them in the Dispatcher, the
    engine and the service), recorded around one Dispatcher.handle call on
    the host clock with the device synchronised at each stage's end. The
    recorded request must answer the same bytes as an unrecorded one, and
    its stages must cover the request's wall time."""
    from prefhetch_tpu_torch.utils.stages import record_stages

    body = {"encryptedPreciseQuery": client.encrypt_query_batch(queries),
            "nearestCoarseVectorIndexes": cand.tolist()}
    if mode != "full":
        body["respMod"] = mode
    if mode in ("packed", "combined"):    # its keys are registered already
        body["keyId"] = client.key_id
    if mode == "combined":
        body["scheme"] = "ckks"
    raw = json.dumps(body).encode()
    status, _, want = disp.handle("POST", "/encryptedsearch", {}, raw)
    if status != 200:
        raise AssertionError(f"POST /encryptedsearch: {status} "
                             f"{want[:300]!r}")
    with record_stages() as times:
        t0 = time.perf_counter()
        status, _, resp = disp.handle("POST", "/encryptedsearch", {}, raw)
        wall = (time.perf_counter() - t0) * 1e3
    if status != 200 or resp != want:
        raise AssertionError("the request answered otherwise while its "
                             "stages were recorded")
    expected = ["json parse", "shape and range checks",
                "ct_from_wire (c1 expansion + host NTT)",
                "prepare (stack, pad, norms)", "upload", "device program",
                "download", "pack_i32", "json.dumps"]
    if mode == "packed":                  # no host expansion of c1
        expected = ["json parse", "shape and range checks",
                    "wire decode (c0 + seeds)", "prepare (pad, norms)",
                    "upload", "device program", "download",
                    "to_wire (base64)", "json.dumps"]
    if mode == "combined":                # CKKS: gather + encode on the card
        expected = ["json parse", "shape and range checks",
                    "wire decode (c0 + seeds)", "upload",
                    "gather and encode", "device program", "download",
                    "to_wire (base64)", "json.dumps"]
    if list(times) != expected:
        raise AssertionError(f"stages recorded: {list(times)}, expected "
                             f"{expected}")
    total = sum(times.values())
    if mode == "full":
        HOST_STAGES["ct_from_wire in a 64-query full request"] = \
            f"{times['ct_from_wire (c1 expansion + host NTT)']:.1f} ms"
    tag = "ckks" if mode == "combined" else "encrypted"
    log(tag, f"one {len(queries)}-query request, respMod={mode}, "
        f"stage by stage on the served path: wall {wall:.1f} ms, stages "
        f"{total:.1f} ms; request {len(raw) / 1e6:.2f} MB, response "
        f"{len(resp) / 1e6:.2f} MB")
    for name, ms in times.items():
        log(tag, f"  {ms:9.3f} ms  {100 * ms / wall:5.1f}%  {name}")
    # what no stage covers is routing and the stats record: a few percent
    if not 0.95 * wall <= total <= wall:
        raise AssertionError(f"the stages sum to {total:.1f} ms of a "
                             f"{wall:.1f} ms request")
    return {"raw": raw, "request_bytes": len(raw), "response_bytes":
            len(resp), "wall_ms": wall, "stages": times}


def phase_encrypted(engine, disp, data, queries, probes, reset_counts):
    """The encrypted re-rank at the operating point of the main phase: K2
    and the device program checked on the first batch, then N_BATCHES
    /coarsesearch + /encryptedsearch rounds with the launch counts read
    around them, exact agreement with precise_search, recall, and where one
    request's time goes. Returns (launches, K2's launches counted around
    each request by response wire, K2's max |err| vs plain)."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.metrics import benchmark_results
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s
    from prefhetch_tpu_torch.ops import union_scan_min as usm

    cfg = engine.config
    k = cfg.protocol.k
    he_full = cfg.he
    he_q1 = dataclasses.replace(he_full, resp_mod="q1", sparse_h=Q1_SPARSE_H)
    t0 = time.perf_counter()
    clients = {"full": HEClient(he_full), "q1": HEClient(he_q1)}
    log("encrypted", f"HE N={he_full.n}, {he_full.n_limbs} limbs, "
        f"t=2^{he_full.t_bits}; two client key sets (dense; sparse h="
        f"{Q1_SPARSE_H}) in {time.perf_counter() - t0:.2f} s")
    cp = cfg.protocol.coarse_probe
    mem0 = torch.cuda.memory_allocated()
    svc = engine.he_service               # parks the int32 base on the card
    torch.cuda.synchronize()
    log("encrypted", f"he_service: int32 base + zero row on the card, "
        f"{(torch.cuda.memory_allocated() - mem0) / 1e9:.3f} GB; device "
        f"memory allocated in all {torch.cuda.memory_allocated() / 1e9:.3f} "
        f"GB")
    # K2 vs plain at the first batch's own stage inputs; the device program
    # against its numpy twin on the first 4 queries
    cand0, _ = post_coarse_topk(disp, queries[:NQ_BATCH], probes[:NQ_BATCH],
                                cp)
    cts0 = [svc.ctx.ct_from_wire(w) for w in
            clients["full"].encrypt_query_batch(queries[:NQ_BATCH])]
    ctq0, idx0, _ = svc.prepare(cts0, cand0)
    ctq0_d, idx0_d = svc.upload(ctq0, idx0)
    k2_err = check_k2_at_request_shape(svc, ctq0_d, idx0_d)
    got4 = svc._trunc_mac(ctq0_d[:4], idx0_d[:4]).cpu().numpy()
    c1_4, c0_4 = svc._trunc_mac_numpy(ctq0[:4, 0], ctq0[:4, 1], idx0[:4])
    if not np.array_equal(got4, np.concatenate([c1_4, c0_4], axis=-1)):
        raise AssertionError("the device program differs from its numpy twin")
    log("encrypted", "device program = numpy twin (host NTT) on 4 "
        "queries x 8 blocks: ok (bit-equal)")
    del ctq0_d, idx0_d

    reset_counts()
    modes = ["full"] * (N_BATCHES - 1) + ["q1"]
    enc_ids, enc_rows, coarse_ms, cands = [], [], [], []
    per_request = {"full": [], "q1": []}   # K2 launches of each request
    enc_err = 0.0
    for b, mode in enumerate(modes):
        sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
        cand, ms = post_coarse_topk(disp, queries[sl], probes[sl], cp)
        coarse_ms.append(ms)
        cands.append(cand)
        before = k2.ntt4_transform.launches
        dists, req, up, down, enc_t, dec_t = post_encrypted(
            disp, clients[mode], queries[sl], cand, mode)
        per_request[mode].append(k2.ntt4_transform.launches - before)
        plain = engine.precise_search(queries[sl], cand)
        enc_err = max(enc_err, float(np.abs(dists - plain).max()))
        if not np.array_equal(dists, plain):
            raise AssertionError(
                f"batch {b} ({mode}): decrypted distances differ from "
                f"precise_search (max |err| {enc_err})")
        order = np.argsort(dists, axis=1, kind="stable")[:, :k]
        enc_ids.append(np.take_along_axis(cand, order, axis=1))
        enc_rows.append(f"{mode}: {req:.1f} ms (request {up / 1e6:.2f} MB, "
                        f"response {down / 1e6:.2f} MB; client encrypt "
                        f"{enc_t:.0f} ms, decrypt {dec_t:.0f} ms)")
    enc_launches = {"union_scan_min": usm.union_scan_min.launches,
                    "ntt4_transform": k2.ntt4_transform.launches}
    enc_plain_calls = (usm.union_scan_min_reference.calls
                       + k2s.ntt4_step_plain.calls)
    L = he_full.n_limbs
    # one launch per transform: per limb a forward NTT of the candidates and
    # an inverse of the c0 products, and for q1 an inverse of c1
    want = {"full": 2 * L, "q1": 3 * L}
    log("encrypted", f"POST /coarsesearch top-{cp} x{N_BATCHES}: "
        f"{', '.join(f'{t:.1f}' for t in coarse_ms)} ms; POST "
        f"/encryptedsearch x{N_BATCHES} of {NQ_BATCH} queries (host clock): "
        + "; ".join(enc_rows))
    log("encrypted", f"launches {enc_launches}; ntt4_transform launches counted "
        f"around each /encryptedsearch request {per_request} (expected "
        f"{want['full']} per full request, {want['q1']} per q1 request), "
        f"plain-version calls {enc_plain_calls}; decrypted distances = "
        f"precise_search, max |err| {enc_err}")
    for mode, counts in per_request.items():
        if not counts or any(c != want[mode] for c in counts):
            raise AssertionError(f"K2 launches per {mode} request {counts}, "
                                 f"expected {want[mode]} each")
    if enc_launches["ntt4_transform"] != sum(map(sum, per_request.values())):
        raise AssertionError("K2 ran outside the /encryptedsearch requests")
    if enc_plain_calls != 0:
        raise AssertionError("a plain version ran on the encrypted path")
    rep_e = benchmark_results(np.concatenate(enc_ids), data["groundtruth"],
                              k=k)
    log("encrypted", f"recall@1 {rep_e.recall_1} recall@10 {rep_e.recall_10} "
        f"recall@100 {rep_e.recall_100} mrr@10 {rep_e.mrr_10}")
    if rep_e.recall_10 < RECALL10_MIN or rep_e.recall_100 < RECALL100_MIN:
        raise AssertionError(
            f"encrypted path: recall@10 {rep_e.recall_10} / recall@100 "
            f"{rep_e.recall_100} below {RECALL10_MIN} / {RECALL100_MIN}")
    for mode in ("full", "q1"):
        encrypted_breakdown(disp, clients[mode], queries[:NQ_BATCH], cand0,
                            mode)
    raw = json.dumps({
        "encryptedPreciseQuery":
            clients["full"].encrypt_query_batch(queries[:NQ_BATCH]),
        "nearestCoarseVectorIndexes": cand0.tolist()}).encode()
    profile_device(
        f"one warm /encryptedsearch request (full, {NQ_BATCH} queries)",
        lambda: disp.handle("POST", "/encryptedsearch", {}, raw))
    return enc_launches, per_request, k2_err, cands, rep_e


def phase_scores(engine, data, queries, cands, reset_counts, smi) -> tuple:
    """BFV whole-ciphertext per-block scores on the engine's HE service
    (HEParams defaults: N=4096, 2 limbs, t=2^24), the encrypted phase's
    first 64 queries and their 256 coarse-round candidates: the client
    encrypts, ``encrypted_scores_batch`` runs on the card (one K2 launch a
    limb over all 512 (query, block) rows), the client decrypts with
    ``decrypt_scores_batch``; distances equal precise_search exactly, the
    ciphertexts bit-equal to ``_mac_numpy``; one query's
    ``encrypted_scores`` is its row of the batch. K2 against its plain
    version at the rows it was launched on, after the counts are read.
    Returns (K2 launches, {"scores batch": [n], "scores single": [n]}, K2's
    max |err|)."""
    import numpy as np

    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.crypto.packing import pack_candidates
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s
    from prefhetch_tpu_torch.utils.stages import record_stages

    cfg = engine.config
    svc = engine.he_service
    L = len(svc.params.qs)
    client = HEClient(cfg.he)
    q = queries[:NQ_BATCH]
    cand = cands[0]
    vecs = data["base"][cand]                         # [64, 256, 128] f32
    t0 = time.perf_counter()
    wires = client.encrypt_query_batch(q)
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cts = [svc.ctx.ct_from_wire(w) for w in wires]
    ct_ms = (time.perf_counter() - t0) * 1e3
    svc.encrypted_scores_batch(cts[:2], vecs[:2])      # warm

    reset_counts()
    with recording_k2(keep_inputs=True) as seen, record_stages() as times:
        t0 = time.perf_counter()
        blocks, norms = svc.encrypted_scores_batch(cts, vecs)
        wall = (time.perf_counter() - t0) * 1e3
    batch_launches = k2.ntt4_transform.launches
    with recording_k2(keep_inputs=True) as seen1:
        one, norms1 = svc.encrypted_scores(cts[5], vecs[5])
    single_launches = k2.ntt4_transform.launches - batch_launches
    plain_calls = k2s.ntt4_step_plain.calls
    nb = len(blocks[0])
    shapes = [(r, str(dt)[6:], "inverse" if inv else "forward")
              for r, dt, inv, _, _ in seen]
    log("scores", f"encrypted_scores_batch: {NQ_BATCH} queries x "
        f"{cand.shape[1]} candidates -> {NQ_BATCH} x {nb} result cts; K2 "
        f"launches {batch_launches} (expected {L}), shapes {shapes}"
        f"; one query's encrypted_scores {single_launches} (expected {L}) at "
        f"{[r for r, *_ in seen1]} rows; plain-version calls {plain_calls}")
    if batch_launches != L or single_launches != L or plain_calls != 0:
        raise AssertionError("whole-ciphertext scores: K2 launches "
                             f"{batch_launches}, {single_launches}, plain "
                             f"calls {plain_calls}")
    if [r for r, *_ in seen] != [NQ_BATCH * nb] * L or \
            [r for r, *_ in seen1] != [nb] * L:
        raise AssertionError("K2 ran at other shapes than one forward "
                             "transform a limb over every (query, block)")

    # the client's decryption: exact distances
    t0 = time.perf_counter()
    out_wires = [[ct.to_wire() for ct in per_q] for per_q in blocks]
    wire_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dists = client.decrypt_scores_batch(out_wires, norms, q)
    dec_ms = (time.perf_counter() - t0) * 1e3
    plain = engine.precise_search(q, cand)
    err = float(np.abs(dists - plain).max())
    if not np.array_equal(dists, plain):
        raise AssertionError(f"whole-ciphertext scores decrypt to other "
                             f"distances than precise_search (max |err| "
                             f"{err})")
    # the numpy twin on every query, and the single query's row
    t0 = time.perf_counter()
    for qi in range(NQ_BATCH):
        polys, _ = pack_candidates(vecs[qi], svc.params)
        o0, o1 = svc._mac_numpy(cts[qi].c0, cts[qi].c1, polys)
        for b, ct in enumerate(blocks[qi]):
            if not (ct.is_ntt and np.array_equal(ct.c0, o0[b])
                    and np.array_equal(ct.c1, o1[b])):
                raise AssertionError(f"query {qi} block {b}: the device "
                                     f"program differs from _mac_numpy")
    twin_ms = (time.perf_counter() - t0) * 1e3
    if len(one) != nb or not np.array_equal(norms1, norms[5]) or not all(
            a.c0.shape == (L, svc.params.n) and np.array_equal(a.c0, b.c0)
            and np.array_equal(a.c1, b.c1) for a, b in zip(one, blocks[5])):
        raise AssertionError("one query's encrypted_scores is not its row "
                             "of the batch")
    log("scores", f"decrypt_scores_batch = precise_search on {NQ_BATCH} x "
        f"{cand.shape[1]}: max |err| {err}; result cts = _mac_numpy on "
        f"every query ({twin_ms:.0f} ms of host twin): ok (bit-equal); one "
        f"query's encrypted_scores [{len(one)} cts of {list(one[0].c0.shape)}]"
        f" = its row of the batch: ok")

    # K2 against its plain version at the rows it ran on (not counted)
    k2_err = 0
    for tag, rec in (("batch", seen), ("single", seen1)):
        for r, _, inverse, tb, x in rec:
            k2_err = max(k2_err, check_transform(
                f"scores {tag} [{r}, {tb.n}]", x, tb, inverse))
    log("kernel", f"ntt4_transform at the whole-ciphertext MAC's rows "
        f"[{NQ_BATCH * nb}, {svc.params.n}] and [{nb}, {svc.params.n}] "
        f"int32, {L} primes: = plain version (max |err| {k2_err})")

    stage_line = ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
    b64 = sum(len(w["c0"]) + len(w["c1"]) for pq in out_wires for w in pq)
    log("scores", f"{smi}: one batch, host clock around "
        f"encrypted_scores_batch with the device synchronised at each "
        f"stage's end: {stage_line}; wall {wall:.3f} ms. Client (host "
        f"clock): encrypt {enc_ms:.1f} ms, ct_from_wire {ct_ms:.1f} ms, "
        f"to_wire {wire_ms:.1f} ms, decrypt_scores_batch {dec_ms:.1f} ms "
        f"({NQ_BATCH * nb} cts, {b64 / 1e6:.2f} MB of base64)")
    return (batch_launches + single_launches,
            {"scores batch": [batch_launches],
             "scores single": [single_launches]}, k2_err)


def check_k2_packed(svc, nq: int, nb: int, n_out: int) -> int:
    """K2 against its plain version at the packed program's own transform
    shapes, on its primes (qs and the special prime): per prime the forward
    transform of the nq·nb·n_comp key-switch digit rows (int32 values <
    2^30, not reduced mod the prime) and the inverse of the 2·nq·nb int32
    sums;
    per limb the forward of the nq·nb lifted candidate rows (int32), the
    inverse of 2·nq·nb MAC rows, the forward of the 2·nq·nb pack rows, the
    inverse of the 2·n_out group sums and the forward of the nq seeded
    masks. Returns the max |difference| (0)."""
    import torch

    tabs = svc._ext_tables
    n, L = svc.params.n, len(svc.params.qs)
    m = nq * nb
    gen = torch.Generator(device=svc.device).manual_seed(11)

    def rows(b, hi, dtype=torch.int64):
        return torch.randint(0, hi, (b, n), generator=gen, device=svc.device,
                             dtype=dtype)

    err = 0
    for e, tb in enumerate(tabs):
        err = max(err,
                  check_transform(f"packed/digits p{e}",
                                  rows(m * L, 1 << 30, torch.int32), tb,
                                  False),
                  check_transform(f"packed/key inverse p{e}",
                                  rows(2 * m, tb.q, torch.int32), tb, True))
    for i, tb in enumerate(tabs[:L]):
        shapes = ((m, False, torch.int32), (2 * m, True, torch.int64),
                  (2 * m, False, torch.int64), (2 * n_out, True, torch.int64),
                  (nq, False, torch.int64))
        for b, inverse, dtype in shapes:
            err = max(err, check_transform(
                f"packed/limb {i} [{b}] {'inverse' if inverse else 'forward'}",
                rows(b, tb.q, dtype), tb, inverse))
    log("kernel", f"ntt4_transform at the packed program's shapes on its "
        f"primes {[t.q for t in tabs]}: digits [{m * L}, {n}], products "
        f"[{2 * m}, {n}], MAC [{m}]/[{2 * m}], pack [{2 * m}]/[{2 * n_out}], "
        f"seeded [{nq}]: ok (max |err| {err})")
    return err


def post_packed(disp, client, queries, cand, gks):
    """One packed /encryptedsearch request through the Dispatcher and the
    client's decryption; ``gks``, the client's Galois keys, go with the
    first request of its keyId (None after). Returns (distances [nq, P]
    f32, request ms, bytes up/down, client encrypt ms, client decrypt ms,
    the number of response ciphertexts)."""
    import numpy as np

    t0 = time.perf_counter()
    body = {"encryptedPreciseQuery": client.encrypt_query_batch(queries),
            "nearestCoarseVectorIndexes": cand.tolist(),
            "respMod": "packed", "keyId": client.key_id}
    if gks is not None:
        body["galoisKeys"] = gks
    raw = json.dumps(body).encode()
    enc_ms = (time.perf_counter() - t0) * 1e3
    if b"preciseQuery" in raw or b'"c1"' in raw:
        raise AssertionError("a plaintext query or a c1 is in the request")
    t0 = time.perf_counter()
    status, _, resp = disp.handle("POST", "/encryptedsearch", {}, raw)
    req_ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"POST /encryptedsearch (packed): {status} "
                             f"{resp[:300]!r}")
    t0 = time.perf_counter()
    out = json.loads(resp)
    dists = client.decrypt_scores_packed(
        out["packedScores"], np.asarray(out["candidateNorms"]), queries,
        out["packGroup"])
    dec_ms = (time.perf_counter() - t0) * 1e3
    return (dists, req_ms, len(raw), len(resp), enc_ms, dec_ms,
            len(out["packedScores"]))


def phase_packed(engine, disp, data, queries, cands, rep_full, reset_counts,
                 smi):
    """The packed BFV response (respMod "packed", seedTf query wires) on the
    candidates of the encrypted phase: K2 at the program's shapes, the
    device program against its numpy twin on the first batch's first G
    queries, then N_BATCHES requests with K2's launches counted around each,
    exact distances, recall equal to the encrypted path's on the same
    candidates, where one request's time goes and its device time by
    kernel. Returns (K2 launches, K2's launches per request, K2's max |err|
    vs plain)."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.metrics import benchmark_results
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s

    cfg = engine.config
    k = cfg.protocol.k
    he = dataclasses.replace(cfg.he, resp_mod="packed")
    t0 = time.perf_counter()
    client = HEClient(he)
    key_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gks = client.bfv_extraction_keys_wire(D)
    gal_ms = (time.perf_counter() - t0) * 1e3
    if client.bfv_extraction_keys_wire(D) is not None:
        raise AssertionError("the client made its Galois keys twice")
    svc = engine.he_service
    L, n = he.n_limbs, he.n
    cp = cfg.protocol.coarse_probe
    B = n // D
    nb = -(-cp // B)
    G = max(1, D // nb)
    n_out = -(-NQ_BATCH // G)
    elts = svc.ctx.extraction_elts(n, D)
    log("packed", f"HE N={n}, {L} limbs, t=2^{he.t_bits}+1 (odd), "
        f"{len(elts)} Galois keys {elts} (30-bit digits, special prime "
        f"{svc.ctx._special_p}): client keys {key_ms:.0f} ms, Galois keys "
        f"{gal_ms:.0f} ms, {len(json.dumps(gks)) / 1e6:.2f} MB on the wire; "
        f"B={B}, nb={nb}, G={G}: {n_out} response cts for {NQ_BATCH} "
        f"queries")
    k2_err = check_k2_packed(svc, NQ_BATCH, nb, n_out)

    # the device program against its numpy twin on the first G queries
    g0 = min(G, NQ_BATCH)
    svc.register_galois_keys(client.key_id, gks)
    wires = client.encrypt_query_batch(queries[:g0])
    resolve = svc.encrypted_scores_packed_wire_async(wires, cands[0][:g0],
                                                     client.key_id)
    got = resolve.dev_out.cpu().numpy()
    cts = [svc.ctx.ct_from_wire(w) for w in wires]
    ctq, pad_idx, _ = svc.prepare(cts, cands[0][:g0])
    t0 = time.perf_counter()
    twin = svc._packed_mac_numpy(ctq, pad_idx, svc._galois_bfv[client.key_id])
    if got.shape != twin.shape or not np.array_equal(got, twin):
        raise AssertionError("the packed device program differs from its "
                             "numpy twin")
    log("packed", f"device program (seedTf entry) = numpy twin (host "
        f"NTT, host key switch; {(time.perf_counter() - t0):.1f} s) on "
        f"{g0} queries x {nb} blocks: ok (bit-equal, c0 and c1)")

    from prefhetch_tpu_torch.ops import key_switch as ks

    ks_fns = (ks.ks_digits, ks.ks_mac, ks.ks_finish)
    reset_counts()
    per_request, ks_per_request, rows, ids = [], [], [], []
    err = 0.0
    for b in range(N_BATCHES):
        sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
        before = k2.ntt4_transform.launches
        ks_before = sum(f.launches for f in ks_fns)
        dists, req, up, down, enc_t, dec_t, n_cts = post_packed(
            disp, client, queries[sl], cands[b], gks if b == 0 else None)
        per_request.append(k2.ntt4_transform.launches - before)
        ks_per_request.append(sum(f.launches for f in ks_fns) - ks_before)
        plain = engine.precise_search(queries[sl], cands[b])
        err = max(err, float(np.abs(dists - plain).max()))
        if not np.array_equal(dists, plain):
            raise AssertionError(f"packed batch {b}: decrypted distances "
                                 f"differ from precise_search (max |err| "
                                 f"{err})")
        order = np.argsort(dists, axis=1, kind="stable")[:, :k]
        ids.append(np.take_along_axis(cands[b], order, axis=1))
        rows.append(f"{req:.1f} ms (request {up / 1e6:.2f} MB"
                    f"{' with the Galois keys' if b == 0 else ''}, response "
                    f"{down / 1e6:.3f} MB, {n_cts} cts; client encrypt "
                    f"{enc_t:.0f} ms, decrypt {dec_t:.0f} ms)")
    launches = k2.ntt4_transform.launches
    plain_calls = k2s.ntt4_step_plain.calls + sum(
        f.calls for f in (ks.ks_digits_plain, ks.ks_mac_plain,
                          ks.ks_finish_plain))
    # one launch per transform: L for the seeded c1, 2L for the MAC, 2 a
    # prime (qs and the special prime) in each of log2(d) rounds, 2L for
    # the pack
    want = L + 2 * L + 2 * (L + 1) * len(elts) + 2 * L
    # the key switch's digits, L + 1 macs and finish a round
    ks_want = (L + 3) * len(elts)
    log("packed", f"POST /encryptedsearch (packed) x{N_BATCHES} of "
        f"{NQ_BATCH} queries (host clock): " + "; ".join(rows))
    log("packed", f"ntt4_transform launches counted around each request "
        f"{per_request} (expected {want}), {launches} in all; key-switch "
        f"kernel launches {ks_per_request} (expected {ks_want}); "
        f"plain-version calls {plain_calls}; decrypted distances = "
        f"precise_search, max |err| {err}")
    if any(c != want for c in per_request) or launches != sum(per_request):
        raise AssertionError(f"K2 launches per packed request {per_request}, "
                             f"{launches} in all; expected {want} each")
    if any(c != ks_want for c in ks_per_request):
        raise AssertionError(f"key-switch launches per packed request "
                             f"{ks_per_request}; expected {ks_want} each")
    if plain_calls != 0:
        raise AssertionError("a plain version ran on the packed path")
    check_key_switch("packed", svc._packed_rotations(client.key_id),
                     len(elts) - 1, NQ_BATCH * nb, torch.int64, smi)
    rep = benchmark_results(np.concatenate(ids), data["groundtruth"], k=k)
    log("packed", f"recall@1 {rep.recall_1} recall@10 {rep.recall_10} "
        f"recall@100 {rep.recall_100} mrr@10 {rep.mrr_10} (encrypted path: "
        f"recall@100 {rep_full.recall_100})")
    if abs(rep.recall_100 - rep_full.recall_100) > 0.005:
        raise AssertionError("packed recall@100 is not within 0.005 of the "
                             "encrypted path's")

    bd = encrypted_breakdown(disp, client, queries[:NQ_BATCH], cands[0],
                             "packed")
    h2d = NQ_BATCH * (L * n * 4 + 2 * 8 + nb * B * 4)
    d2h = n_out * 2 * L * n * 4
    log("packed", f"bytes of that request: body {bd['request_bytes']:,} up, "
        f"{bd['response_bytes']:,} down; to the card {h2d:,} (c0, the "
        f"threefry keys, the indices), from the card {d2h:,} ({n_out} "
        f"ciphertexts); the full wire's result "
        f"{NQ_BATCH * nb * L * (n + B) * 4:,} bytes from the card")
    wall, busy, prof = profile_device(
        f"one warm /encryptedsearch request (packed, {NQ_BATCH} queries)",
        lambda: disp.handle("POST", "/encryptedsearch", {}, bd["raw"]))
    k2_ms = sum(us for us, key, _ in prof if "ntt4_kernel" in key) / 1e3
    if prof:
        log("profile", f"  K2 (ntt4_kernel) {k2_ms:.4f} ms of the device's "
            f"busy {busy:.3f} ms ({100 * k2_ms / busy:.1f}%); device busy "
            f"{100 * busy / wall:.1f}% of the request's {wall:.1f} ms")
    return launches, per_request, k2_err


def ckks_he():
    """BASELINE.json config 3's HE parameters: CKKS N=8192, 3 limbs of ~30
    bits (and the special prime), scale 2^26, the combined response."""
    from prefhetch_tpu_torch.utils.config import HEParams

    return HEParams(scheme="ckks", n=8192, n_limbs=3, scale_bits=26,
                    resp_mod="combined")


def ckks_errors(dists, rows, queries):
    """(bench.py's ckks_max_rel_err: per query the largest |error| of the
    decrypted distances over the largest float64 distance, the worst
    query's; the largest |error|). rows [nq, P, d] are the candidates'
    base rows."""
    import numpy as np

    ref = ((rows.astype(np.float64)
            - queries[:, None].astype(np.float64)) ** 2).sum(-1)
    err = np.abs(dists.astype(np.float64) - ref).max(-1)
    return (float((err / np.maximum(ref.max(-1), 1.0)).max()),
            float(err.max()))


def bench_ckks_candidates(top_ids, p: int, nbase: int):
    """bench.py's CKKS workload (``_pad_candidates``, :2017-2027): each
    query's final top-k ids padded to p with the consecutive base rows
    after its last id (mod nbase)."""
    import numpy as np

    k = top_ids.shape[1]
    extra = (top_ids[:, -1:] + 1 + np.arange(p - k)[None, :]) % nbase
    return np.concatenate([top_ids, extra], axis=1)


def check_k2_ckks(svc) -> int:
    """K2 against its plain version at the CKKS program's shapes on its
    four primes (the chain and the special prime): at the largest row count
    the combined program gives it ([2,048, 8,192]: the pre-combine key
    switch's 512 rows x 4 digit components) and at [128, 8,192]; forward
    of 15-bit digits (int32) and of residues (int64), inverse of residues
    (int64) and of the key switch's sums (int32), as the program gives
    them. Returns the max |difference| (0)."""
    import torch

    n = svc.params.n
    gen = torch.Generator(device=svc.device).manual_seed(13)
    err = 0
    for e, tb in enumerate(svc._tables):
        for rows in (2048, 128):
            for what, hi, inverse, dtype in (
                    ("digits", 1 << 15, False, torch.int32),
                    ("residues", tb.q, False, torch.int64),
                    ("residues", tb.q, True, torch.int64),
                    ("key-switch sums", tb.q, True, torch.int32)):
                x = torch.randint(0, hi, (rows, n), generator=gen,
                                  device=svc.device, dtype=dtype)
                err = max(err, check_transform(
                    f"ckks/p{e} [{rows}] {what} "
                    f"{'inverse' if inverse else 'forward'}", x, tb,
                    inverse))
    log("kernel", f"ntt4_transform at the CKKS program's shapes on its "
        f"primes {list(svc.ext)}: [2048, {n}] and [128, {n}], digits and "
        f"residues forward, residues and sums inverse: ok (max |err| "
        f"{err})")
    return err


def post_ckks(disp, client, queries, cand, gks, combined: bool):
    """One CKKS /encryptedsearch request through the Dispatcher and the
    client's decryption; ``gks`` go with the first request of the client's
    keyId. Returns (distances [nq, P] f32, request ms, bytes up/down,
    client encrypt ms, client decrypt ms, the number of response cts)."""
    import numpy as np

    t0 = time.perf_counter()
    body = {"scheme": "ckks", "keyId": client.key_id,
            "encryptedPreciseQuery": client.encrypt_query_batch(queries),
            "nearestCoarseVectorIndexes": cand.tolist()}
    if combined:
        body["respMod"] = "combined"
    if gks is not None:
        body["galoisKeys"] = gks
    raw = json.dumps(body).encode()
    enc_ms = (time.perf_counter() - t0) * 1e3
    if b"preciseQuery" in raw:
        raise AssertionError("the plaintext query is in the request")
    t0 = time.perf_counter()
    status, _, resp = disp.handle("POST", "/encryptedsearch", {}, raw)
    req_ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"POST /encryptedsearch (ckks): {status} "
                             f"{resp[:300]!r}")
    t0 = time.perf_counter()
    out = json.loads(resp)
    norms = np.asarray(out["candidateNorms"])
    if combined:
        cts = out["encryptedScoresCombined"]
        if len(cts) != len(queries) or any(c["level"] != 1 for c in cts):
            raise AssertionError("not one level-1 ct a query")
        dists = client.decrypt_scores_combined(cts, norms, queries)
        n_cts = len(cts)
    else:
        dists = client.decrypt_scores_batch(out["encryptedScores"], norms,
                                            queries)
        n_cts = sum(len(c) for c in out["encryptedScores"])
    dec_ms = (time.perf_counter() - t0) * 1e3
    return dists, req_ms, len(raw), len(resp), enc_ms, dec_ms, n_cts


def phase_ckks(engine, disp, data, queries, cands, reset_counts, smi):
    """CKKS slot-packed encrypted scoring (BASELINE.json config 3) on the
    engine, index and base of the main phase and the candidates of the
    encrypted phase: K2 against its plain version at the program's primes
    and row counts, the device program (host encode) bit-equal to its
    numpy twin on the first query and the served gather form bit-equal to
    the row-upload device encode on the first batch; then N_BATCHES
    combined requests of 64 seedTf queries (the first carrying the 10
    Galois keys) and one per-block request of 8 queries, with K2's
    launches counted around each, the decrypted distances' max relative
    error, recall, where one request's time goes and its device time by
    kernel. Returns (K2 launches, K2's launches per request, K2's max
    |err| vs plain)."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.engine.hecompute import CKKSComputeService
    from prefhetch_tpu_torch.metrics import benchmark_results
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s
    from prefhetch_tpu_torch.ops import key_switch as ks

    t_phase = time.perf_counter()
    cfg = engine.config
    k, cp = cfg.protocol.k, cfg.protocol.coarse_probe
    he = ckks_he()
    # the same engine, index and base serve config 3's HE parameters: its
    # CKKS service is built from them, the BFV phases keep theirs
    engine.config = dataclasses.replace(cfg, he=he)
    try:
        svc = engine.ckks_service
    finally:
        engine.config = cfg
    base_np = data["base"]
    t0 = time.perf_counter()
    client = HEClient(he)
    key_ms = (time.perf_counter() - t0) * 1e3
    nb = client.combine_blocks(cp, D)
    t0 = time.perf_counter()
    gks = client.galois_keys_wire(D, nb)
    gal_ms = (time.perf_counter() - t0) * 1e3
    if len(gks) != 10 or client.galois_keys_wire(D, nb) is not None:
        raise AssertionError("the client did not make its 10 Galois keys "
                             "once")
    log("ckks", f"{smi}: HE CKKS N={he.n}, {he.n_limbs} limbs {svc.ext[:3]} "
        f"+ special prime {svc.ext[3]}, scale 2^{he.scale_bits}, d={D}, "
        f"P={cp}: {nb} blocks, window {D // nb}; client keys {key_ms:.0f} "
        f"ms, 10 Galois keys (15-bit digits) {gal_ms:.0f} ms, "
        f"{len(json.dumps(gks)) / 1e6:.2f} MB on the wire")
    k2_err = check_k2_ckks(svc)

    # the device program against its numpy twin on the first query, and
    # the served gather form against the row-upload device encode
    t0 = time.perf_counter()
    svc.register_keys(client.key_id, gks)
    reg_ms = (time.perf_counter() - t0) * 1e3
    q0, cand0 = queries[:NQ_BATCH], cands[0]
    rows0 = engine.base[torch.from_numpy(cand0).to(engine.device)]
    rows0 = rows0.cpu().numpy().astype(np.float64)         # [64, P, d]
    wires0 = client.encrypt_query_batch(q0)
    host, host_norms = svc.encrypted_scores_combined_batch(
        wires0[:1], rows0[:1], client.key_id)
    t0 = time.perf_counter()
    twin = CKKSComputeService(svc.params)
    twin.register_keys(client.key_id, gks)
    t_ct, t_norms = twin.encrypted_scores_combined(
        svc.ctx.ct_from_wire(wires0[0]), rows0[0], client.key_id)
    twin_s = time.perf_counter() - t0
    if not (np.array_equal(host[0].c0, t_ct.c0)
            and np.array_equal(host[0].c1, t_ct.c1)
            and host[0].level == t_ct.level == 1
            and abs(host[0].scale - t_ct.scale) <= 1e-6 * abs(t_ct.scale)
            and np.array_equal(host_norms[0], t_norms)):
        raise AssertionError("the CKKS device program (host encode) "
                             "differs from its numpy twin")
    if svc._base_dev is None:
        svc.set_base(engine.base)
    ids0 = cand0.astype(np.int32)
    g_cts, g_norms = svc.encrypted_scores_combined_batch(wires0, ids0,
                                                         client.key_id)
    r_cts, r_norms = svc.encrypted_scores_combined_batch(
        wires0, rows0, client.key_id, dev_encode=True)
    if not (all(np.array_equal(g.c0, r.c0) and np.array_equal(g.c1, r.c1)
                for g, r in zip(g_cts, r_cts))
            and np.array_equal(g_norms, r_norms)):
        raise AssertionError("the gather form differs from the row-upload "
                             "device encode")
    # what the f32 encode product rounds otherwise than the host FFT, and
    # what that does to the decrypted distances: the served form against
    # the host-encode program (the reference's arithmetic, bit-equal to the
    # numpy twin) on the same 64 ciphertexts
    cand_scale = float(1 << CKKSComputeService.CAND_SCALE_BITS)
    flat = rows0.reshape(-1, (he.n // 2 // D) * D) / cand_scale
    host_coeffs = svc.ctx.encode(flat)
    dev_coeffs = svc._encode(torch.from_numpy(
        flat.astype(np.float32)).to(svc.device)).cpu().numpy()
    diff = np.abs(dev_coeffs.astype(np.int64) - host_coeffs)
    h_cts, h_norms = svc.encrypted_scores_combined_batch(wires0, rows0,
                                                         client.key_id)
    d_host = client.decrypt_scores_combined(
        [c.to_wire() for c in h_cts], h_norms, q0)
    d_served = client.decrypt_scores_combined(
        [c.to_wire() for c in g_cts], g_norms, q0)
    d_twin = client.decrypt_scores_combined([t_ct.to_wire()],
                                            t_norms[None], q0[:1])
    rel_host, abs_host = ckks_errors(d_host, rows0, q0)
    rel_served, abs_served = ckks_errors(d_served, rows0, q0)
    rel_twin, abs_twin = ckks_errors(d_twin, rows0[:1], q0[:1])
    ref = ((rows0 - q0[:, None].astype(np.float64)) ** 2).sum(-1)
    log("ckks", f"device program (host encode) = numpy twin "
        f"(CKKSComputeService, {twin_s:.1f} s) on 1 query x {nb} blocks: ok "
        f"(bit-equal, c0 and c1, level 1, scale, norms); gather form = "
        f"row-upload device encode on {NQ_BATCH} queries: ok (bit-equal); "
        f"f32 device encode vs host FFT encode: {int((diff > 0).sum())} of "
        f"{diff.size} coefficients differ, max |diff| {int(diff.max())} "
        f"(|coeff| up to {int(np.abs(host_coeffs).max())}); key "
        f"registration (host NTT into four-step order) {reg_ms:.0f} ms")
    log("ckks", f"{smi}: the combined response's precision on the coarse "
        f"round's 256 candidates of the first batch (distances "
        f"{ref.min():.0f} to {ref.max():.0f}): max |distance error| "
        f"{abs_twin:.1f} (relative {rel_twin:.6f}) for the numpy twin on "
        f"query 0, {abs_host:.1f} ({rel_host:.6f}) for the host-encode "
        f"program, {abs_served:.1f} ({rel_served:.6f}) served (gather + "
        f"f32 encode) on {NQ_BATCH} queries")
    # the f32 encode re-draws the rescales' rounding, so the served form is
    # held to the size of the reference arithmetic's error, not its values
    if abs_served > 1.5 * abs_host or abs_host > CKKS_COMBINED_MAX_ABS:
        raise AssertionError(f"combined error {abs_served} served, "
                             f"{abs_host} host encode: above 1.5 x the host "
                             f"encode's or {CKKS_COMBINED_MAX_ABS}")
    del rows0, g_cts, r_cts, h_cts

    # the main path: N_BATCHES combined requests, then one per-block one
    reset_counts()
    per_request, rows, ids, enc_all = [], [], [], []
    err, err_abs = 0.0, 0.0
    for b in range(N_BATCHES):
        sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
        before = k2.ntt4_transform.launches
        dists, req, up, down, enc_t, dec_t, n_cts = post_ckks(
            disp, client, queries[sl], cands[b], gks if b == 0 else None,
            combined=True)
        per_request.append(k2.ntt4_transform.launches - before)
        rel, abs_ = ckks_errors(dists, base_np[cands[b]], queries[sl])
        err, err_abs = max(err, rel), max(err_abs, abs_)
        order = np.argsort(dists, axis=1, kind="stable")[:, :k]
        ids.append(np.take_along_axis(cands[b], order, axis=1))
        if b == 0:
            HOST_STAGES["CKKS first combined request with its keys"] = \
                f"{req:.1f} ms"
        enc_all.append(enc_t)
        rows.append(f"{req:.1f} ms (request {up / 1e6:.2f} MB"
                    f"{' with the Galois keys' if b == 0 else ''}, response "
                    f"{down / 1e6:.3f} MB, {n_cts} cts; client encrypt "
                    f"{enc_t:.0f} ms, decrypt {dec_t:.0f} ms)")
    HOST_STAGES["CKKS client encrypting 64 queries"] = \
        f"{min(enc_all):.0f}-{max(enc_all):.0f} ms"
    pb_client = HEClient(dataclasses.replace(he, resp_mod="full"))
    pb_gks = pb_client.galois_keys_wire(D)
    nq_pb = 8
    before = k2.ntt4_transform.launches
    pb_d, pb_req, pb_up, pb_down, pb_enc, pb_dec, pb_cts = post_ckks(
        disp, pb_client, queries[:nq_pb], cands[0][:nq_pb], pb_gks,
        combined=False)
    pb_launches = k2.ntt4_transform.launches - before
    pb_err = ckks_errors(pb_d, base_np[cands[0][:nq_pb]],
                         queries[:nq_pb])[0]
    launches = k2.ntt4_transform.launches
    plain_calls = k2s.ntt4_step_plain.calls + sum(
        f.calls for f in (ks.ks_digits_plain, ks.ks_mac_plain,
                          ks.ks_finish_plain))
    # bench.py's CKKS workload on the first batch: the exact top-100 of the
    # coarse candidates padded with consecutive base rows (after the counts
    # are read: a measurement, not the path)
    exact0 = engine.precise_search(q0, cand0)
    top0 = np.take_along_axis(
        cand0, np.argsort(exact0, axis=1, kind="stable")[:, :k], axis=1)
    bench_cand = bench_ckks_candidates(top0, cp, len(base_np))
    bd_d = post_ckks(disp, client, q0, bench_cand, None, combined=True)[0]
    bench_err, bench_abs = ckks_errors(bd_d, base_np[bench_cand], q0)
    # one launch per transform. Combined: 2 per input prime for ct x pt
    # (3), 2 per prime of the level and the special prime for each
    # pre-combine rotation (3 x 3), 2 per active prime for the mask (2), 2
    # per prime for each tree round and each post-combine rotation (2 x
    # (3 + 4)). Per-block: ct x pt, then log2(d) = 7 rotations x 3 x 2
    want, want_pb = 6 + 18 + 4 + 12 + 16, 6 + 7 * 6
    log("ckks", f"POST /encryptedsearch (ckks, combined) x{N_BATCHES} of "
        f"{NQ_BATCH} seedTf queries (host clock): " + "; ".join(rows))
    log("ckks", f"POST /encryptedsearch (ckks, per-block) of {nq_pb} "
        f"queries: {pb_req:.1f} ms (request {pb_up / 1e6:.2f} MB with 7 "
        f"Galois keys, response {pb_down / 1e6:.3f} MB, {pb_cts} level-2 "
        f"cts; client encrypt {pb_enc:.0f} ms, decrypt {pb_dec:.0f} ms)")
    log("ckks", f"ntt4_transform launches counted around each combined "
        f"request {per_request} (expected {want}), the per-block request "
        f"{pb_launches} (expected {want_pb}), {launches} in all, "
        f"plain-version calls {plain_calls}")
    log("ckks", f"{smi}: max relative distance error (bench.py's "
        f"ckks_max_rel_err: max |err| / max distance): combined "
        f"{err:.6f} on the coarse round's candidates (max |err| "
        f"{err_abs:.1f}), {bench_err:.6f} on bench.py's workload (top-{k} "
        f"padded with consecutive rows; max |err| {bench_abs:.1f}); "
        f"per-block {pb_err:.6f} (limit {CKKS_MAX_REL}); the combined "
        f"response is held to its own precision, max |err| <= "
        f"{CKKS_COMBINED_MAX_ABS:.0f}")
    if any(c != want for c in per_request) or pb_launches != want_pb \
            or launches != sum(per_request) + pb_launches:
        raise AssertionError(f"K2 launches per ckks request {per_request}, "
                             f"{pb_launches}, {launches} in all; expected "
                             f"{want} and {want_pb}")
    if plain_calls != 0:
        raise AssertionError("a plain version ran on the ckks path")
    if pb_err > CKKS_MAX_REL:
        raise AssertionError(f"ckks per-block max relative error {pb_err} "
                             f"above {CKKS_MAX_REL}")
    if max(err_abs, bench_abs) > CKKS_COMBINED_MAX_ABS:
        raise AssertionError(f"ckks combined max |distance error| "
                             f"{max(err_abs, bench_abs)} above "
                             f"{CKKS_COMBINED_MAX_ABS}")
    rep = benchmark_results(np.concatenate(ids), data["groundtruth"], k=k)
    order = np.argsort(pb_d, axis=1, kind="stable")[:, :k]
    rep_pb = benchmark_results(
        np.take_along_axis(cands[0][:nq_pb], order, axis=1),
        data["groundtruth"][:nq_pb], k=k)
    log("ckks", f"recall of the client's top-{k} after decryption: "
        f"combined recall@1 {rep.recall_1} recall@10 {rep.recall_10} "
        f"recall@100 {rep.recall_100} mrr@10 {rep.mrr_10}; per-block "
        f"({nq_pb} queries) recall@10 {rep_pb.recall_10} recall@100 "
        f"{rep_pb.recall_100}")
    if rep_pb.recall_10 < RECALL10_MIN or rep_pb.recall_100 < RECALL100_MIN:
        raise AssertionError(
            f"ckks per-block: recall@10 {rep_pb.recall_10} / recall@100 "
            f"{rep_pb.recall_100} below {RECALL10_MIN} / {RECALL100_MIN}")

    bd = encrypted_breakdown(disp, client, q0, cand0, "combined")
    L = he.n_limbs
    h2d = NQ_BATCH * (L * he.n * 4 + 2 * 8 + nb * (he.n // 2 // D) * 4)
    d2h = NQ_BATCH * (2 * he.n * 4 + nb * (he.n // 2 // D) * 8)
    log("ckks", f"bytes of that request: body {bd['request_bytes']:,} up, "
        f"{bd['response_bytes']:,} down; to the card {h2d:,} (c0, the "
        f"threefry keys, the padded ids), from the card {d2h:,} ({NQ_BATCH} "
        f"level-1 cts and the norms)")
    wall, busy, prof = profile_device(
        f"one warm /encryptedsearch request (ckks combined, {NQ_BATCH} "
        f"queries)",
        lambda: disp.handle("POST", "/encryptedsearch", {}, bd["raw"]))
    k2_ms = sum(us for us, key, _ in prof if "ntt4_kernel" in key) / 1e3
    k2_n = sum(c for _, key, c in prof if "ntt4_kernel" in key)
    other_n = sum(c for _, key, c in prof if "ntt4_kernel" not in key)
    if prof:
        log("profile", f"  {smi}: K2 (ntt4_kernel) {k2_ms:.4f} ms in "
            f"{k2_n} launches of the device's busy {busy:.3f} ms "
            f"({100 * k2_ms / busy:.1f}%); {other_n} other device events "
            f"(elementwise int64, gathers, copies, the encode matmul); "
            f"device busy {100 * busy / wall:.1f}% of the request's "
            f"{wall:.1f} ms")
    log("ckks", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return (launches, {"ckks_combined": per_request,
                       "ckks_per_block": pb_launches}, k2_err)


def check_k2_pir_database(svc, built) -> int:
    """K2 against its plain version at the database's transform: the
    service's own launches at build time (``built``, recorded with their
    input: [g1·g2, N] int32 values below t, one forward a limb), whose
    output is svc.db, against the plain version of that same input; then
    that launch's time beside its bound. Returns the max |difference| (0)."""
    from prefhetch_tpu_torch.ops.ntt4 import ntt4

    L, n = len(svc.params.qs), svc.params.n
    if [(b[2], b[3].q) for b in built] != [(False, tb.q)
                                          for tb in svc._tabs_q]:
        raise AssertionError("the database was not one forward K2 a limb")
    db = svc.db.view(-1, L, n)
    err = 0
    for i, (_, _, _, tb, x) in enumerate(built):
        err = max(err, check_transform(f"pir/db limb {i}", x, tb, False,
                                       got=db[:, i]))
    x, tb0 = built[0][4], built[0][3]
    t_db = cuda_time_ms(lambda: ntt4(x, tb0), iters=5, warmup=1)
    db_in = x.numel() * 8
    ops = 2 * x.numel() * (tb0.n1 + tb0.n2) * INT8_MACS_PER_MODMAC
    log("timing", f"ntt4_transform forward at the database's [{x.shape[0]}, "
        f"{n}] int32 (CUDA events): {t_db:.4f} ms a limb, bound "
        f"{db_in / HBM_BYTES_S * 1e3:.4f} ms (bytes, {db_in / 1e6:.1f} MB; "
        f"int8 {ops / INT8_OPS * 1e3:.4f} ms)")
    log("kernel", f"ntt4_transform at the PIR database [{x.shape[0]}, {n}] "
        f"int32 on {list(svc.params.qs)}: the build's own launches = the "
        f"plain version of their input (max |err| {err})")
    return err


def check_k2_path(tag: str, recorded: dict, device) -> int:
    """K2 against its plain version at every shape a path gave it: each
    (rows, input dtype, direction, prime) recorded around the path's
    requests, on fresh residues below q of that dtype, one launch each.
    Returns the max |difference| (0)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(17)
    seen, err, n_rows = {}, 0, 0
    for launches in recorded.values():
        for rows, dtype, inverse, tb, _ in launches:
            seen.setdefault((rows, dtype, inverse, tb.q), tb)
    for (rows, dtype, inverse, q), tb in sorted(
            seen.items(), key=lambda kv: kv[0][0]):
        x = torch.randint(0, q, (rows, tb.n), generator=gen,
                          device=device, dtype=dtype)
        err = max(err, check_transform(
            f"{tag}/[{rows}] {str(dtype)[6:]} "
            f"{'inverse' if inverse else 'forward'} mod {q}", x, tb, inverse))
        n_rows += rows
        del x
    for name, launches in recorded.items():
        fwd = max((b for b in launches if not b[2]), key=lambda b: b[0])
        inv = max((b for b in launches if b[2]), key=lambda b: b[0])
        log("kernel", f"ntt4_transform on {name}: {len(launches)} launches, "
            f"the widest [{fwd[0]}, {fwd[3].n}] {str(fwd[1])[6:]} forward "
            f"and [{inv[0]}, {inv[3].n}] {str(inv[1])[6:]} inverse")
    log("kernel", f"ntt4_transform at all {len(seen)} (rows, dtype, "
        f"direction, prime) of the {tag} path ({n_rows:,} rows in all) = "
        f"its plain version (max |err| {err})")
    return err


def widest_key_switch(launches, sp: int) -> tuple:
    """The widest forward and inverse K2 launch of the key switch among
    ``launches`` (its transforms on the special prime ``sp``, which only
    the key switch runs): ((rows, dtype), (rows, dtype), tables)."""
    ks = [b for b in launches if b[3].q == sp]
    fwd = max((b for b in ks if not b[2]), key=lambda b: b[0])
    inv = max((b for b in ks if b[2]), key=lambda b: b[0])
    return (fwd[0], fwd[1]), (inv[0], inv[1]), fwd[3]


def check_key_switch(tag: str, rot, r: int, M: int, dtype, smi: str) -> None:
    """The rotation step's kernels (csrc/key_switch.cu) at round r of the
    rotations ``rot`` over M ciphertexts of fresh residues in the program's
    storage dtype: the digits, each prime's mac and the finish bit-equal to
    their plain versions on the same inputs, each kernel timed (CUDA
    events) beside its byte bound (its operands read once, its results
    written once)."""
    import torch

    from prefhetch_tpu_torch.ops import key_switch as ks
    from prefhetch_tpu_torch.ops.ntt4 import intt4, ntt4

    dev = rot.kb.device
    l = len(rot.tabs) - 1
    n = rot.tabs[0].n
    qs, p = [tb.q for tb in rot.tabs[:l]], rot.tabs[-1].q
    gen = torch.Generator(device=dev).manual_seed(M)
    x0, x1, y1 = (torch.stack([torch.randint(
        0, q, (M, n), generator=gen, device=dev, dtype=dtype)
        for q in qs], 1) for _ in range(3))
    perm, neg = rot.perm[r], rot.neg[r]
    bits = rot.digit_bits
    flat = ks.ks_digits(y1, perm, neg, qs, bits)
    torch.cuda.synchronize()
    if not torch.equal(flat, ks.ks_digits_plain(y1, perm, neg, qs, bits)):
        raise AssertionError(f"{tag}: ks_digits differs from its plain "
                             f"version at M={M}")
    ms = {"digits": cuda_time_ms(
        lambda: ks.ks_digits(y1, perm, neg, qs, bits), iters=5, warmup=1)}
    esz = y1.element_size()
    rows = M * l * n
    bound = {"digits": rows * esz + flat.numel() * 4}
    parts, mac_ms = [], []
    for e, tb in enumerate(rot.tabs):
        d = ntt4(flat, tb)
        kb, ka = rot.kb[r][:, e], rot.ka[r][:, e]
        s01 = ks.ks_mac(d, kb, ka, tb.q)
        torch.cuda.synchronize()
        if not torch.equal(s01, ks.ks_mac_plain(d, kb, ka, tb.q)):
            raise AssertionError(f"{tag}: ks_mac differs from its plain "
                                 f"version mod {tb.q} at M={M}")
        mac_ms.append(cuda_time_ms(lambda: ks.ks_mac(d, kb, ka, tb.q),
                                   iters=5, warmup=1))
        parts.append(intt4(s01, tb))
        del d, s01
    del flat
    ms["mac"] = sum(mac_ms) / len(mac_ms)
    n_comp = rot.kb.shape[1]
    bound["mac"] = (M + 2) * n_comp * n * 4 + 2 * M * n * 4
    got = ks.ks_finish(parts, x0, x1, y1, perm, neg, qs, p)
    torch.cuda.synchronize()
    want = ks.ks_finish_plain(parts, x0, x1, y1, perm, neg, qs, p)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag}: ks_finish differs from its plain "
                             f"version at M={M}")
    del got, want
    ms["finish"] = cuda_time_ms(
        lambda: ks.ks_finish(parts, x0, x1, y1, perm, neg, qs, p), iters=5,
        warmup=1)
    bound["finish"] = (l + 1) * 2 * M * n * 4 + 5 * rows * esz
    log("kernel", f"{tag}: key-switch kernels at round {r} over M={M:,} "
        f"[{l} limbs, N={n}, {str(dtype)[6:]}, {bits}-bit digits] = their "
        f"plain versions (digits, {l + 1} macs, finish)")
    log("timing", f"{smi}: {tag} key switch at M={M:,} (CUDA events), "
        + ", ".join(f"{k} {v:.4f} ms (bound {bound[k] / HBM_BYTES_S * 1e3:.4f}"
                    f" ms, {bound[k] / 1e9:.3f} GB; "
                    f"{100 * bound[k] / HBM_BYTES_S * 1e3 / v:.1f}%)"
                    for k, v in ms.items())
        + " (the mac a prime)")


def phase_pir(engine, disp, base_np, top_ids, reset_counts, smi):
    """Private row retrieval on the engine and base of the main phase: the
    engine's DevicePIR2 built on the card (pack_database on the host, the
    database's transform by K2, held against its plain version on the
    build's own input), the device program bit-equal to the numpy oracle
    PIR2Server at nbase 5,000; then the path: one POST /pir-fetch of 4
    single-row queries (pirHypercube) and the client's stage 8 on one
    query's top-K rows through the multi-row wire (pirHypercubeMulti),
    with K2's launches counted and their shapes recorded around each and
    every row decoded exactly; K2 against its plain version at every shape
    recorded; the dim-1 fold's kernel once a program; then where one
    multi-row request's time goes, the fold's kernel beside its plain
    version and its bounds, the device's busy share, and K2's time at the
    multi-row key switch's widest round. Returns (K2 launches, launches
    per request, K2's max |err| vs plain, K2's timing at the key-switch
    shape, the path's description)."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.client.pir import get_pir_client
    from prefhetch_tpu_torch.client.pipeline import ClientPipeline
    from prefhetch_tpu_torch.crypto.pir import PIR2Server, PIRClient
    from prefhetch_tpu_torch.engine import pir_device
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s
    from prefhetch_tpu_torch.ops import key_switch as ks
    from prefhetch_tpu_torch.ops import pir_fold
    from prefhetch_tpu_torch.utils import stages
    from prefhetch_tpu_torch.utils.stages import record_stages

    t_phase = time.perf_counter()
    cfg = engine.config
    nbase, d = base_np.shape
    k = top_ids.shape[1]
    ks_plains = (ks.ks_digits_plain, ks.ks_mac_plain, ks.ks_finish_plain)

    def ks_launches() -> int:
        return ks.ks_digits.launches + ks.ks_mac.launches \
            + ks.ks_finish.launches

    # the service, built lazily by the engine as a request would
    before = k2.ntt4_transform.launches
    torch.cuda.synchronize()
    with record_stages() as build, recording_k2(keep_inputs=True) as built:
        t0 = time.perf_counter()
        svc = engine.pir2_service
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
    build_launches = k2.ntt4_transform.launches - before
    p = svc.params
    L = len(p.qs)
    db_bytes = svc.db.numel() * svc.db.element_size()
    G = -(-nbase // (p.n // d))
    log("pir", f"{smi}: PIR N={p.n}, t={p.t}, limbs {list(p.qs)} + special "
        f"prime {svc._ext[-1]}; nbase {nbase}, d={d}: {p.n // d} rows a "
        f"block, G={G}, grid {svc.g1} x {svc.g2}, m={svc.m}, single-row "
        f"logm {svc.logm} (m_pad {svc.m_pad}), {svc._n_digits} response "
        f"digits, {svc.rows_per_ct()} rows a multi-row ct")
    log("pir", f"service built in {build_ms:.0f} ms: pack_database "
        f"{build['pack_database']:.0f} ms (host), database upload + "
        f"transform {build['database upload + transform']:.0f} ms with "
        f"{build_launches} K2 launches; the database on the card "
        f"{db_bytes / 1e6:.1f} MB {list(svc.db.shape)} int32 (four-step "
        f"NTT order), one pass at 3.35 TB/s = "
        f"{db_bytes / HBM_BYTES_S * 1e3:.3f} ms")
    if build_launches != L:
        raise AssertionError(f"the database took {build_launches} K2 "
                             f"launches, not {L}")
    k2_err = check_k2_pir_database(svc, built)
    del built

    # the device program against the numpy oracle at nbase 5,000
    t0 = time.perf_counter()
    small = base_np[:5000]
    dev_s, host_s = DevicePIR2(small, p, device=svc.device), \
        PIR2Server(small, p)
    c_s = PIRClient(p)
    gw = c_s.galois_keys_wire_2d(len(small), d)
    dev_s.register_galois_keys(c_s.key_id, gw)
    host_s.register_galois_keys(c_s.key_id, gw)
    row_s = min(4321, len(small) - 1)
    w, r = c_s.build_query_2d(row_s, len(small), d)
    t1 = time.perf_counter()
    rd = dev_s.answer_2d(w, c_s.key_id)
    dev_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    rh = host_s.answer_2d(w, c_s.key_id)
    host_ms = (time.perf_counter() - t1) * 1e3
    if rd != rh or not np.array_equal(c_s.decode_response_2d(rd, d, r),
                                      small[row_s]):
        raise AssertionError("DevicePIR2 differs from PIR2Server at nbase "
                             "5,000")
    log("pir", f"DevicePIR2 on the card = PIR2Server (numpy) at nbase 5,000 "
        f"(grid {dev_s.g1} x {dev_s.g2}): one answer_2d bit-equal, the row "
        f"exact; device {dev_ms:.0f} ms (first call), host {host_ms:.0f} ms; "
        f"{time.perf_counter() - t0:.1f} s with keys and set-up")
    del dev_s, host_s

    # the client: keys before the path (its own host work, timed here)
    t0 = time.perf_counter()
    mclient = get_pir_client(cfg)
    key_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gks1 = mclient.galois_keys_wire_2d(nbase, d)
    gal1_ms = (time.perf_counter() - t0) * 1e3
    k_ct = mclient.rows_per_ct(nbase, d)
    t0 = time.perf_counter()
    gksm = mclient.galois_keys_wire_2d_multi(nbase, d, k_ct)
    galm_ms = (time.perf_counter() - t0) * 1e3
    rows4 = [int(x) for x in top_ids[0, :4]]
    t0 = time.perf_counter()
    q4 = [mclient.build_query_2d(r_, nbase, d) for r_ in rows4]
    enc4_ms = (time.perf_counter() - t0) * 1e3
    body4 = json.dumps({"pirHypercube": [w_ for w_, _ in q4],
                        "keyId": mclient.key_id,
                        "galoisKeys": gks1}).encode()

    captured = {}

    def send(method, route, body):
        t0 = time.perf_counter()
        status, _, out = disp.handle(method, "/" + route, {}, body)
        captured.update(req=body, resp=out,
                        ms=(time.perf_counter() - t0) * 1e3)
        if status != 200:
            raise AssertionError(f"{method} /{route}: {status} {out[:300]!r}")
        return out

    tclient = ClientPipeline(cfg, send=send)

    # -- the path ----------------------------------------------------------
    reset_counts()
    with recording_k2() as shapes4:
        t0 = time.perf_counter()
        status, _, resp4 = disp.handle("POST", "/pir-fetch", {}, body4)
        single_ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"POST /pir-fetch: {status} {resp4[:300]!r}")
    single_launches = k2.ntt4_transform.launches
    single_folds = pir_fold.fold_dim1.launches
    single_ks = ks_launches()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with recording_k2() as shapes_m:
        t0 = time.perf_counter()
        vecs, ids = tclient.get_precise_vectors_real_pir(top_ids[:1])
        stage8_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - mem0
    launches = k2.ntt4_transform.launches
    multi_launches = launches - single_launches
    multi_folds = pir_fold.fold_dim1.launches - single_folds
    multi_ks = ks_launches() - single_ks
    plain_calls = (k2s.ntt4_step_plain.calls + pir_fold.fold_dim1_plain.calls
                   + sum(f.calls for f in ks_plains))
    # -----------------------------------------------------------------------

    res4 = json.loads(resp4)["pirResults"]
    for row, (_, r_), resp in zip(rows4, q4, res4):
        if not np.array_equal(mclient.decode_response_2d(resp, d, r_),
                              base_np[row]):
            raise AssertionError(f"pirHypercube row {row} decoded wrong")
    if not np.array_equal(vecs[0], base_np[ids[0]]):
        raise AssertionError("the multi-row stage 8 decoded rows that are "
                             "not the base's")
    n_cts = -(-k // k_ct)
    logm_multi = max(1, (k_ct * svc.m - 1).bit_length())

    def programs(logm: int, cts: int) -> int:
        return -(-cts // max(1, pir_device.MAX_EXPANDED >> logm))

    def want(logm: int, cts: int) -> int:
        # 6 a level of the expansion (forward and inverse on 3 primes), 4 a
        # limb for the selectors and the two folds; a program a chunk
        return programs(logm, cts) * (6 * logm + 4 * L)

    want1, wantm = want(svc.logm, 4), want(logm_multi, n_cts)
    folds1, foldsm = programs(svc.logm, 4), programs(logm_multi, n_cts)
    log("pir", f"client (host): keygen {key_ms:.0f} ms, Galois keys for "
        f"{svc.logm} levels {gal1_ms:.0f} ms "
        f"({len(json.dumps(gks1)) / 1e6:.2f} MB), the {logm_multi - svc.logm}"
        f" deeper levels of the multi-row wire {galm_ms:.0f} ms "
        f"({len(json.dumps(gksm)) / 1e6:.2f} MB in all); 4 single-row "
        f"queries {enc4_ms:.0f} ms")
    log("pir", f"POST /pir-fetch pirHypercube of 4 rows with the Galois "
        f"keys: {single_ms:.1f} ms (host clock; key registration included), "
        f"request {len(body4) / 1e6:.2f} MB, response "
        f"{len(resp4) / 1e6:.3f} MB, rows exact; K2 launches "
        f"{single_launches} (expected {want1} = 6·{svc.logm} + 4·{L})")
    log("pir", f"stage 8 (ClientPipeline.get_precise_vectors_real_pir) on "
        f"{k} rows of one query: {n_cts} cts of {k_ct} rows "
        f"(nRows {k_ct}, the last padded), a {logm_multi}-level expansion; "
        f"{stage8_ms:.0f} ms in all, the request {captured['ms']:.0f} ms "
        f"(with the {logm_multi}-level keys), request "
        f"{len(captured['req']) / 1e6:.2f} MB, response "
        f"{len(captured['resp']) / 1e6:.2f} MB, rows exact; K2 launches "
        f"{multi_launches} (expected {wantm} = 6·{logm_multi} + 4·{L} a "
        f"program of at most {pir_device.MAX_EXPANDED >> logm_multi} cts); "
        f"peak device memory of the request {peak / 2**30:.2f} GiB above the "
        f"{mem0 / 2**30:.2f} GiB already allocated; plain-version calls "
        f"{plain_calls}")
    log("pir", f"dim-1 fold kernel launches: {single_folds} and "
        f"{multi_folds} (expected {folds1} and {foldsm}, one a program)")
    # the digits, L + 1 macs and the finish a round of the expansion
    ks1, ksm = folds1 * 5 * svc.logm, foldsm * 5 * logm_multi
    log("pir", f"key-switch kernel launches: {single_ks} and {multi_ks} "
        f"(expected {ks1} and {ksm}, five a round)")
    if (single_ks, multi_ks) != (ks1, ksm):
        raise AssertionError(f"key-switch launches {single_ks}, {multi_ks};"
                             f" expected {ks1}, {ksm}")
    if single_launches != want1 or multi_launches != wantm:
        raise AssertionError(f"K2 launches {single_launches}, "
                             f"{multi_launches}; expected {want1}, {wantm}")
    if (single_folds, multi_folds) != (folds1, foldsm):
        raise AssertionError(f"dim-1 fold launches {single_folds}, "
                             f"{multi_folds}; expected {folds1}, {foldsm}")
    if plain_calls != 0:
        raise AssertionError("a plain version ran on the pir path")
    if (len(shapes4), len(shapes_m)) != (single_launches, multi_launches):
        raise AssertionError("the recorded K2 launches differ from the "
                             "counted ones")
    # K2 against its plain version at every shape the two requests gave it
    k2_err = max(k2_err, check_k2_path("pir", {
        "the 4-row pirHypercube request": shapes4,
        f"the {n_cts}-ct pirHypercubeMulti request": shapes_m}, svc.device))
    sp = svc._ext[-1]
    ks_fwd, ks_inv, ks_tb = widest_key_switch(shapes_m, sp)
    ks4_fwd, ks4_inv, _ = widest_key_switch(shapes4, sp)
    del shapes4, shapes_m

    # where one multi-row request's time goes (keys registered: the
    # client's next request)
    body = json.loads(captured["req"])
    body.pop("galoisKeys", None)
    raw = json.dumps(body).encode()
    t0 = time.perf_counter()
    stages.clear_spans()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with record_stages() as times:
        t1 = time.perf_counter()
        status, _, out = disp.handle("POST", "/pir-fetch", {}, raw)
        wall = (time.perf_counter() - t1) * 1e3
    peak = torch.cuda.max_memory_allocated() - mem0
    if status != 200 or out != captured["resp"]:
        raise AssertionError("the repeated multi-row request answered "
                             "otherwise")
    rec = stages.recorded_spans()
    names = {sp.id: sp.name for sp in rec["spans"]}
    ks_by = {}
    for c in rec["counters"]:
        if c.name == "he.ks.launches":
            ks_by[names[c.span]] = ks_by.get(names[c.span], 0) + c.n
    if ks_by != {"expansion (K2 + elementwise)": ksm}:
        raise AssertionError(f"he.ks.launches by stage {ks_by}; expected "
                             f"{ksm} on the expansion")
    log("pir", f"{smi}: he.ks.launches of the warm request {ks_by} "
        f"({5 * logm_multi} a program); the program's peak "
        f"{peak:,} B above the {mem0:,} B already allocated, "
        f"{peak + db_bytes:,} B with the database (PR 25: 30,871,388,160 "
        f"above its base, 31,904,990,208 with the database)")
    covered = sum(times.values())
    log("pir", f"{smi}: one warm POST /pir-fetch pirHypercubeMulti ({n_cts} "
        f"cts x {k_ct} rows) by stage: " + ", ".join(
            f"{name} {ms:.2f} ms" for name, ms in times.items())
        + f"; request wall {wall:.1f} ms (stages {100 * covered / wall:.1f}%"
        f" of it), {len(raw):,} bytes up, {len(out):,} down")
    rows_all = [int(x) for x in ids.reshape(-1)]
    chunks = [rows_all[i:i + k_ct] for i in range(0, len(rows_all), k_ct)]
    t0 = time.perf_counter()
    for ch in chunks:
        mclient.build_query_2d_multi(ch + [ch[-1]] * (k_ct - len(ch)),
                                     nbase, d)
    enc_ms = (time.perf_counter() - t0) * 1e3
    res = json.loads(out)["pirResults"]
    t0 = time.perf_counter()
    for resp in res[:k]:
        mclient.decode_response_2d(resp, d, 0)
    dec_ms = (time.perf_counter() - t0) * 1e3
    HOST_STAGES[f"PIR client decoding {k} rows"] = f"{dec_ms:.0f} ms"
    log("pir", f"client (host) for that fetch: {n_cts} multi-row queries "
        f"{enc_ms:.0f} ms, decoding {k} rows {dec_ms:.0f} ms")

    # the dim-1 fold alone at both paths' widths: its kernel (the service's
    # own call, on the strided view of the program's selectors) bit-equal
    # to its plain version, both timed, beside its two bounds
    gen = torch.Generator(device=svc.device).manual_seed(5)
    for S in (4, n_cts * k_ct):
        sel = torch.empty((S, svc.m, 2, L, p.n), dtype=torch.int32,
                          device=svc.device)
        for i, q in enumerate(p.qs):
            sel[..., i, :] = torch.randint(
                0, q, (S, svc.m, 2, p.n), generator=gen, device=svc.device,
                dtype=torch.int32)
        s1 = sel[:, :svc.g1]
        before = pir_fold.fold_dim1.launches
        got = svc._fold_dim1(s1)
        torch.cuda.synchronize()
        if pir_fold.fold_dim1.launches != before + 1 or not torch.equal(
                got, pir_fold.fold_dim1_plain(s1, svc.db, p.qs)):
            raise AssertionError(f"the dim-1 fold kernel differs from its "
                                 f"plain version at S={S}")
        del got
        t_fold = cuda_time_ms(lambda: svc._fold_dim1(s1), iters=5, warmup=1)
        t_plain = cuda_time_ms(
            lambda: pir_fold.fold_dim1_plain(s1, svc.db, p.qs),
            iters=2, warmup=1)
        io = S * (svc.g1 + svc.g2) * 2 * L * p.n * 4
        macs = S * 2 * svc.g1 * svc.g2 * L * p.n
        log("pir", f"{smi}: dim-1 fold of {S} selector sets (CUDA events): "
            f"kernel {t_fold:.4f} ms, plain version {t_plain:.3f} ms, "
            f"bit-equal; bound by bytes (the database once, its selectors "
            f"read and canonical int32 sums written once) "
            f"{(db_bytes + io) / HBM_BYTES_S * 1e3:.4f} ms "
            f"({100 * (db_bytes + io) / HBM_BYTES_S * 1e3 / t_fold:.2f}% of "
            f"it); by multiply-adds ({macs / 1e9:.2f} G IMAD.WIDE at "
            f"~{MAD_WIDE_S / 1e12:.2f} T/s) "
            f"{macs / MAD_WIDE_S * 1e3:.4f} ms "
            f"({100 * macs / MAD_WIDE_S * 1e3 / t_fold:.1f}% of it)")
        del sel, s1
    log("pir", f"dim-1 fold kernel launches over the phase: "
        f"{pir_fold.fold_dim1.launches}, plain-version calls "
        f"{pir_fold.fold_dim1_plain.calls} (the checks and timings)")

    # the key-switch kernels at the multi-row expansion's widest round
    check_key_switch("pir", svc._keys[mclient.key_id], logm_multi - 1,
                     min(n_cts, pir_device.MAX_EXPANDED >> logm_multi)
                     << logm_multi, torch.int32, smi)

    wall_p, busy, prof = profile_device(
        f"one warm /pir-fetch ({n_cts} multi-row cts)",
        lambda: disp.handle("POST", "/pir-fetch", {}, raw))
    k2_ms = sum(us for us, key, _ in prof if "ntt4_kernel" in key) / 1e3
    k2_n = sum(c for _, key, c in prof if "ntt4_kernel" in key)
    if prof:
        log("profile", f"  {smi}: K2 (ntt4_kernel) {k2_ms:.4f} ms in "
            f"{k2_n} launches of the device's busy {busy:.3f} ms "
            f"({100 * k2_ms / busy:.1f}%); device busy "
            f"{100 * busy / wall_p:.1f}% of the request's {wall_p:.1f} ms")

    # K2 at the multi-row key switch's widest round, on the special prime
    k2_pir = time_ntt4_transform(ks_tb, ks_fwd[0],
                                 forward_int64=ks_fwd[1] == torch.int64,
                                 inverse_rows=ks_inv[0],
                                 inverse_int64=ks_inv[1] == torch.int64)
    k2_pir.update(
        shape=[ks_fwd[0], p.n], dtype=str(ks_fwd[1])[6:],
        inverse_shape=[ks_inv[0], p.n], inverse_dtype=str(ks_inv[1])[6:],
        single_row_x4_shapes=[[ks4_fwd[0], p.n], [ks4_inv[0], p.n]])
    log("pir", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    path = (f"POST /pir-fetch x2 (pirHypercube of 4 rows; "
            f"pirHypercubeMulti of {n_cts} cts x {k_ct} rows, stage 8 of "
            f"one query)")
    return (launches, {"pir_single_x4": single_launches,
                       f"pir_multi_{n_cts}cts": multi_launches},
            k2_err, k2_pir, path)


def time_ntt4_transform(tb, nbatch: int, forward_int64: bool = False,
                        inverse_rows: int | None = None,
                        inverse_int64: bool = True) -> dict:
    """K2 per transform at a request's shape ([nbatch, N]): the forward
    transform of int32 residues (int64 with ``forward_int64``) and the
    inverse of int64 ones (int32 without ``inverse_int64``, as the key
    switch gives it its sums; of ``inverse_rows`` rows if given), as the
    request runs them, each beside the plain version and the card's bound.
    Returns the timing keys of K2's entry in the kernels line (means of the
    two directions; each direction's own under "forward"/"inverse")."""
    import torch

    from prefhetch_tpu_torch.ops import ntt4 as n4

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    fwd = torch.int64 if forward_int64 else torch.int32
    for name, inverse, dtype, rows_n in (
            ("forward", False, fwd, nbatch),
            ("inverse", True, torch.int64 if inverse_int64 else torch.int32,
             inverse_rows or nbatch)):
        fn = n4.intt4 if inverse else n4.ntt4
        # 6 x 25 MB in + out: past L2; two copies of an input of a GB
        n_x = 6 if rows_n * tb.n * dtype.itemsize < 1 << 30 else 2
        xs = [torch.randint(0, tb.q, (rows_n, tb.n), device=dev, dtype=dtype,
                            generator=gen)
              for _ in range(n_x)]
        x0 = xs[0]
        # the plain version over slices of 2^26 elements (its float64
        # stages take ~40 bytes an element)
        step = max(1, (1 << 26) // tb.n)
        t_k = cuda_time_ms(lambda: fn(x0, tb))
        t_p = cuda_time_ms(lambda: [fn(x0[i:i + step], tb, plain=True)
                                    for i in range(0, rows_n, step)])
        t_k2 = cuda_time_ms(lambda: fn(x0, tb))
        ring = iter(range(10 ** 9))
        t_cold = cuda_time_ms(lambda: fn(xs[next(ring) % n_x], tb), iters=24)
        t_dev = kernel_ms(lambda: fn(x0, tb), "ntt4_kernel", min(t_k, t_k2))
        # bytes: input read once, int32 output written once, the four digit
        # tables and the packed twiddles read once
        nbytes = (rows_n * tb.n * (x0.element_size() + 4)
                  + 4 * (tb.n1 ** 2 + tb.n2 ** 2) + tb.n * 8)
        # int8 multiply-adds: two stages of [64, n2] outputs over k = 64 and
        # k = n2, 16 digit products each; 2 operations a multiply-add
        macs = rows_n * tb.n * (tb.n1 + tb.n2) * INT8_MACS_PER_MODMAC
        t_b, t_o = nbytes / HBM_BYTES_S, 2 * macs / INT8_OPS
        rows[name] = {
            "ms": t_dev, "ms_events": min(t_k, t_k2),
            "ms_inputs_past_l2": t_cold, "plain_ms": t_p,
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes_ms": t_b * 1e3, "int8_ms": t_o * 1e3}
        log("timing", f"ntt4_transform {name} at [{rows_n}, {tb.n}] "
            f"{str(dtype)[6:]} in, int32 out: kernel {t_dev:.4f} ms on the "
            f"device (CUDA events over wrapper calls {min(t_k, t_k2):.4f}, "
            f"inputs past L2 {t_cold:.4f}), plain {t_p:.4f} ms, library "
            f"call none, bound {max(t_b, t_o) * 1e3:.4f} ms "
            f"({nbytes / 1e6:.2f} MB = {t_b * 1e3:.4f} ms; {macs / 1e9:.2f} "
            f"G int8 multiply-adds = {t_o * 1e3:.4f} ms), "
            f"{max(t_b, t_o) * 1e3 / t_dev:.0%} of the bound")
    keys = ("ms", "ms_events", "ms_inputs_past_l2", "plain_ms", "bound_ms")
    out = {k: sum(r[k] for r in rows.values()) / len(rows) for k in keys}
    out["bound_by"] = rows["forward"]["bound_by"]
    out.update(rows)
    return out


def profile_device(what: str, run):
    """torch.profiler over run() (warm requests): device time by kernel and
    the device's busy share of the host wall clock; the rest is host work
    the device waits on. Returns (wall ms, device busy ms, [(device us,
    kernel name, count)] largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    log("profile", f"{what}: wall {wall_ms:.3f} ms, {busy}")
    for dev_us, key, count in rows[:10]:
        log("profile", f"  {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
    return wall_ms, busy_ms, rows


def profile_search(disp, queries, probes, k: int) -> None:
    """Where a /search request's time goes: the profile of N_BATCHES warm
    requests, and the host-only batch preparation (probe expansion, union,
    upload) alone."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.utils import wire_bin

    reqs = [wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
        queries[b * NQ_BATCH:(b + 1) * NQ_BATCH],
        probes[b * NQ_BATCH:(b + 1) * NQ_BATCH], np.array([k], np.uint32),
    ]) for b in range(N_BATCHES)]
    hdr = {"content-type": wire_bin.CONTENT_TYPE}

    def run():
        for r in reqs:
            disp.handle("POST", "/search", hdr, r)

    profile_device(f"{N_BATCHES} warm /search requests", run)
    t0 = time.perf_counter()
    for b in range(N_BATCHES):
        sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
        disp.engine._tiled_batch_prep(probes[sl], queries[sl])
    torch.cuda.synchronize()
    log("profile", f"host batch preparation alone: "
        f"{(time.perf_counter() - t0) * 1e3 / N_BATCHES:.3f} ms per batch")


def check_answers(tag, ids, dists, base64, q64, groundtruth, k):
    """What every plaintext path must return for all the queries: [nq, k]
    finite ascending distances that are the exact distances of the returned
    ids (float64 on the card as the independent yardstick; SIFT-style
    integer data makes the f32 re-rank exact), ids in range, and recall
    above the limits. Returns (the recall report, max |distance error|)."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.metrics import benchmark_results

    nq_all = NQ_BATCH * N_BATCHES
    if ids.shape != (nq_all, k) or dists.shape != (nq_all, k):
        raise AssertionError(f"{tag}: bad result shapes {ids.shape} "
                             f"{dists.shape}")
    if not np.isfinite(dists).all() or (np.diff(dists, axis=1) < 0).any():
        raise AssertionError(f"{tag}: distances not finite and ascending")
    if ids.min() < 0 or ids.max() >= NBASE:
        raise AssertionError(f"{tag}: ids out of range")
    exact = ((base64[torch.from_numpy(ids).to(base64.device)]
              - q64[:, None]) ** 2).sum(-1).cpu().numpy()
    np.testing.assert_allclose(dists, exact, rtol=1e-6, atol=1e-3)
    rep = benchmark_results(ids, groundtruth, k=k)
    if rep.recall_10 < RECALL10_MIN or rep.recall_100 < RECALL100_MIN:
        raise AssertionError(
            f"{tag}: recall@10 {rep.recall_10} / recall@100 "
            f"{rep.recall_100} below {RECALL10_MIN} / {RECALL100_MIN}")
    return rep, float(np.abs(dists - exact).max())


def kernel_counters():
    """({name: wrapper with .launches}, [plain versions with .calls]) of
    every kernel of the port."""
    from prefhetch_tpu_torch.ops import kernel_counters as counters

    return counters()


def check_slab(name, kernel, plain, args) -> float:
    """K5 or K4 against its plain version on the same card tensors; args as
    the wrapper takes them (payload, norms, sizes, [vmin, scale,] queries,
    probe_ids). Same PAD lanes; valid lanes within the f32 summation error
    of the distance's three terms, 1e-5 (|q|^2 + max |x|^2). Returns the max
    |difference| over valid lanes."""
    import torch

    from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE

    got = kernel(*args)
    torch.cuda.synchronize()              # a fault in the run shows here
    want = plain(*args)
    payload, norms, q, probe_ids = args[0], args[1], args[-2], args[-1]
    nq, max_t = probe_ids.shape
    if got.shape != (nq, max_t * payload.shape[1]) \
            or got.dtype != torch.float32:
        raise AssertionError(f"{name}: output {got.shape} {got.dtype}")
    pad = want >= PAD_DISTANCE / 2
    if not torch.equal(got >= PAD_DISTANCE / 2, pad):
        raise AssertionError(f"{name}: PAD pattern differs")
    tol = 1e-5 * ((q * q).sum(-1)[:, None] + norms.max())
    err = torch.where(pad, torch.zeros_like(got), (got - want).abs())
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: differs from the plain version, max "
                             f"err/tol {float((err / tol).max())}")
    err = float(err.max())
    log("kernel", f"{name}: nq={nq} max_t={max_t} T={payload.shape[1]} "
        f"d={payload.shape[2]} {payload.dtype}: ok (max |d2 err| {err}, "
        f"tolerance {float(tol.min())}..{float(tol.max())})")
    return err


def check_schedule(name, probe_ids, n_tiles, chunk=0) -> int:
    """The tile schedule of K4 and K5 against torch.sort(stable=True) on
    the same card tensor, bit for bit, and with ``chunk`` its piece list
    against the plain version's. Returns the max |difference| of the sorted
    keys and the order (0, or it raises)."""
    import torch

    from prefhetch_tpu_torch.ops import slab_scan as k45

    got = k45.tile_schedule(probe_ids, n_tiles, chunk)
    torch.cuda.synchronize()              # a fault in the run shows here
    keys = probe_ids.reshape(-1).to(
        torch.int16 if n_tiles <= 32768 else torch.int32)
    want = torch.sort(keys, stable=True)
    err = max(int((got[0].long() - want.values.long()).abs().max()),
              int((got[1] - want.indices).abs().max()))
    if got[0].dtype != want.values.dtype or err != 0:
        raise AssertionError(f"{name}: the schedule differs from "
                             f"torch.sort(stable=True) (max |err| {err})")
    note = ""
    if chunk:
        plain = k45.tile_schedule_plain(probe_ids, n_tiles, chunk)[2]
        n = int(plain[0])
        if not torch.equal(got[2][:1 + 2 * n], plain[:1 + 2 * n]):
            raise AssertionError(f"{name}: the piece list differs")
        note = f", {n} pieces of at most {chunk} pairs equal"
    log("kernel", f"{name}: tile_schedule of {probe_ids.numel()} pairs over "
        f"{n_tiles} tiles ({keys.dtype} keys): bit-equal to "
        f"torch.sort(stable=True){note}")
    return err


def check_pq_probed(name, codes, lutq, lutp, cadd, sizes, tile_list,
                    tiles) -> float:
    """K3 against its plain version on the same card tensors. Same PAD
    lanes; both round the table sum to bf16 the same way and add the M terms
    in f32 in another order before the same scalar: 1e-5 (M (max |lutq| +
    max |lutp|) + max |cadd|). Returns the max |difference| over valid
    lanes."""
    import torch

    from prefhetch_tpu_torch.ops import pq_onehot as k3
    from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE

    args = (codes, lutq, lutp, cadd, sizes, tile_list, tiles)
    got = k3.pq_probed_distances(*args)
    torch.cuda.synchronize()              # a fault in the run shows here
    want = k3.pq_probed_distances_plain(*args)
    _, T, M = codes.shape
    nq, max_t = tiles.shape
    if got.shape != (nq, max_t * T) or got.dtype != torch.float32:
        raise AssertionError(f"{name}: output {got.shape} {got.dtype}")
    pad = want >= PAD_DISTANCE / 2
    if not torch.equal(got >= PAD_DISTANCE / 2, pad):
        raise AssertionError(f"{name}: PAD pattern differs")
    tol = 1e-5 * (M * float(lutq.abs().max() + lutp.abs().max())
                  + float(cadd.abs().max()))
    err = float(torch.where(pad, torch.zeros_like(got),
                            (got - want).abs()).max())
    if not err <= tol:
        raise AssertionError(f"{name}: differs from the plain version, max "
                             f"|err| {err} > {tol}")
    log("kernel", f"{name}: nq={nq} max_t={max_t} T={T} M={M} "
        f"ksub={lutq.shape[1] // M}: ok (max |err| {err}, "
        f"tolerance {tol})")
    return err


def phase_variant_edges() -> None:
    """K5, K4 and K3 at edge shapes: tiles of size T, 1, T-1, 0, T/2 and the
    empty tile, a probe row of nothing but the empty tile, nq not a multiple
    of any block, d past one pass of a warp's lanes, code bytes loaded one
    at a time (M not a multiple of 16), tables of up to 100 KB, a zero list
    part, one probe slot."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.ops import pq_onehot as k3
    from prefhetch_tpu_torch.ops import slab_scan as k45

    dev = torch.device("cuda:0")

    def slab_case(T, d, nq, max_t, dtype, seed):
        rng = np.random.default_rng(seed)
        sizes = np.array([T, 1, T - 1, 0, T // 2, 0], np.int32)
        if dtype == torch.uint8:
            x = rng.integers(0, 256, (6, T, d)).astype(np.uint8)
        else:
            x = rng.normal(scale=40.0, size=(6, T, d)).astype(np.float32)
        for i, s in enumerate(sizes):
            x[i, s:] = 0
        q = np.abs(rng.normal(scale=40.0, size=(nq, d))).astype(np.float32)
        probes = rng.integers(0, 6, (nq, max_t)).astype(np.int32)
        probes[0, :4] = [0, 1, 2, 3]
        probes[-1] = 5
        return (torch.from_numpy(x).to(dev, dtype),
                torch.from_numpy(sizes).to(dev), torch.from_numpy(q).to(dev),
                torch.from_numpy(probes).to(dev))

    for T, d, nq, max_t, dtype in (
            (1024, 128, 7, 8, torch.bfloat16), (100, 200, 5, 4, torch.float32),
            (64, 32, 70, 5, torch.bfloat16)):
        payload, sizes, q, probes = slab_case(T, d, nq, max_t, dtype, T + d)
        norms = (payload.float() ** 2).sum(-1).contiguous()
        for chunk in (0, k45.SLAB_CHUNK):
            check_schedule(f"edge/T={T} nq={nq}", probes, payload.shape[0],
                           chunk)
        got_last = k45.slab_distances(payload, norms, sizes, q, probes)[-1]
        if not bool((got_last >= 3e38).all()):
            raise AssertionError("an all-empty probe row is not all PAD")
        check_slab(f"edge/slab_distances T={T}", k45.slab_distances,
                   k45.slab_distances_plain,
                   (payload, norms, sizes, q, probes))
    for T, d, nq, max_t in ((1024, 128, 7, 8), (100, 48, 5, 4),
                            (64, 32, 70, 5)):
        codes, sizes, q, probes = slab_case(T, d, nq, max_t, torch.uint8,
                                            T + d + 1)
        g = torch.Generator().manual_seed(T)
        vmin = (torch.rand(d, generator=g) * 10 - 5).to(dev)
        scale = (torch.rand(d, generator=g) * 0.8 + 0.2).to(dev)
        norms = ((vmin + (codes.float() + 0.5) * scale) ** 2).sum(-1)
        check_schedule(f"edge/T={T} nq={nq}", probes, codes.shape[0])
        check_slab(f"edge/slab_distances_sq8 T={T}", k45.slab_distances_sq8,
                   k45.slab_distances_sq8_plain,
                   (codes, norms.contiguous(), sizes, vmin, scale, q, probes))
    # the tile-major K4 and K5 at the schedule's hard cases, 64 queries of
    # 8 slots: tile 0 probed by every query (a run of 64 pairs), tile 2
    # probed twice by one query, and a batch of nothing but size-0 tiles
    for dtype, T, d in ((torch.uint8, 1024, 128), (torch.bfloat16, 1024, 128),
                        (torch.float32, 100, 200)):
        payload, sizes, q, probes = slab_case(T, d, 64, 8, dtype, 5)
        if dtype == torch.uint8:
            g = torch.Generator().manual_seed(5)
            vmin = (torch.rand(d, generator=g) * 10 - 5).to(dev)
            scale = (torch.rand(d, generator=g) * 0.8 + 0.2).to(dev)
            norms = ((vmin + (payload.float() + 0.5) * scale) ** 2).sum(-1)
            kernel = k45.slab_distances_sq8
            plain = k45.slab_distances_sq8_plain
            chunk, aligned, aff = k45.SQ8_CHUNK, False, (vmin, scale)
        else:
            norms = (payload.float() ** 2).sum(-1)
            kernel, plain = k45.slab_distances, k45.slab_distances_plain
            chunk, aligned, aff = k45.SLAB_CHUNK, True, ()
        norms = norms.contiguous()
        probes[:, 0] = 0
        probes[1, 1:3] = 2
        all_empty = probes.clone()
        all_empty[:] = torch.tensor([3, 5], dtype=torch.int32,
                                    device=dev).repeat(4)
        for tag, pids in (("tile 0 probed by all 64 queries", probes),
                          ("only size-0 tiles", all_empty)):
            check_schedule(f"edge/{tag}", pids, payload.shape[0],
                           chunk if aligned else 0)
            _, _, length, _ = k45.tile_runs(
                k45.tile_schedule(pids, payload.shape[0])[0], chunk, aligned)
            args = (payload, norms, sizes, *aff, q, pids)
            check_slab(f"edge/{kernel.__name__} {payload.dtype} {tag} (runs "
                       f"{length.numel()}, longest {int(length.max())})",
                       kernel, plain, args)
            if pids is all_empty and not bool((kernel(*args) >= 3e38).all()):
                raise AssertionError("a batch of size-0 tiles is not all PAD")
    # the schedule past int16 tile ids (int32 keys, counts in device
    # memory), and past the pairs it stages in shared memory
    gen = torch.Generator(device=dev).manual_seed(1)
    big = torch.randint(0, 40000, (64, 48), dtype=torch.int32, device=dev,
                        generator=gen)
    big[:, :3] = 39999
    many = torch.randint(0, 1474, (128, 64), dtype=torch.int32, device=dev,
                         generator=gen)
    for chunk in (0, k45.SLAB_CHUNK):
        check_schedule("edge/40,000 tiles", big, 40000, chunk)
        check_schedule("edge/8,192 pairs", many, 1474, chunk)
    # K3: tiles of size T, 1, T-1, 0, ... and the empty tile 9; a probe row
    # of nothing but the empty tile (nq > 1); one probe slot; byte-wise
    # code loads (M=8, 200); tables of 16 to 100 KB; ksub=64 with a zero
    # list table; one query and 70
    for T, M, ksub, nq, max_t, zero_p in (
            (256, 32, 256, 13, 11, False), (100, 8, 256, 5, 4, False),
            (64, 200, 256, 3, 3, False), (64, 16, 64, 3, 5, True),
            (32, 16, 256, 1, 3, False), (16, 32, 256, 70, 2, False),
            (64, 32, 256, 6, 1, False)):
        rng = np.random.default_rng(T + M + nq + max_t)
        ntiles, nlist = 9, 4
        codes = rng.integers(0, ksub, (ntiles + 1, T, M)).astype(np.uint8)
        codes[-1] = 0
        sizes = np.array([T, 1, T - 1, 0, T // 2, T, min(3, T), T,
                          min(2, T), 0], np.int32)
        lutq = (rng.normal(size=(nq, M * ksub)) * 3000).astype(np.float32)
        lutp = (rng.normal(size=(nlist, M * ksub)) * 700).astype(np.float32)
        if zero_p:
            lutp[:] = 0
        cadd = (rng.normal(size=(nq, nlist)) * 3000 * M ** 0.5).astype(
            np.float32)
        tile_list = np.sort(rng.integers(0, nlist, ntiles + 1)).astype(
            np.int32)
        tiles = rng.integers(0, ntiles + 1, (nq, max_t)).astype(np.int32)
        tiles[0, :min(4, max_t)] = np.arange(min(4, max_t))
        if nq > 1:
            tiles[-1] = ntiles
        args = [torch.from_numpy(a).to(dev) for a in (
            codes, lutq, lutp, cadd, sizes, tile_list, tiles)]
        check_pq_probed(f"edge/pq_probed T={T} M={M} ksub={ksub} nq={nq} "
                        f"max_t={max_t}", *args)
        if nq > 1:
            last = k3.pq_probed_distances(*args)[-1]
            if not bool((last >= 3e38).all()):
                raise AssertionError("an all-empty probe row is not all PAD")


def slab_bound(view, probe_ids, q, sq8: bool):
    """The card's bound for one slab scan: every probed tile's valid rows
    (payload and norms) read once though several queries probe it, the
    queries, indices and the affine once, the f32 output written once; the
    matvecs' multiply-adds over the valid rows of every (query, tile) pair
    at the f32 rate outside the tensor cores. Returns (ms, bound_by, MB,
    GFLOP)."""
    import torch

    T, d = view.payload.shape[1:]
    flat = probe_ids.reshape(-1).long()
    rows = int(view.sizes[torch.unique(flat)].sum())
    pair_rows = int(view.sizes[flat].sum())
    distinct = torch.unique(flat)
    nbytes = (rows * d * view.payload.element_size() + rows * 4
              + distinct.numel() * 4 + flat.numel() * 4 + q.numel() * 4
              + (2 * d * 4 if sq8 else 0) + flat.numel() * T * 4)
    flops = 2.0 * d * pair_rows
    t_b, t_o = nbytes / HBM_BYTES_S, flops / F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes / 1e6, flops / 1e9)


def time_schedule(probe_ids, n_tiles: int, chunk: int) -> dict:
    """The tile schedule at a batch's shape: its kernel's device time, the
    plain version (torch.sort, and the piece list in torch ops), one
    torch.sort(stable=True) of the keys (the function without the piece
    list) and the card's bound: the keys read once, the sorted keys, the
    order and the pieces this batch makes written once."""
    import torch

    from prefhetch_tpu_torch.ops import slab_scan as k45

    def run():
        return k45.tile_schedule(probe_ids, n_tiles, chunk)

    ms = cuda_time_ms(run)
    plain_ms = cuda_time_ms(
        lambda: k45.tile_schedule_plain(probe_ids, n_tiles, chunk), iters=10)
    dev = kernel_ms(run, "tile_schedule_kernel", ms)
    keys = probe_ids.reshape(-1).to(
        torch.int16 if n_tiles <= 32768 else torch.int32)
    library_ms = cuda_time_ms(lambda: torch.sort(keys, stable=True))
    library_dev = device_ms(lambda: torch.sort(keys, stable=True))
    n_pieces = int(run()[2][0]) if chunk else 0
    P = keys.numel()
    nbytes = P * 4 + P * keys.element_size() + P * 8 \
        + (4 + 8 * n_pieces if chunk else 0)
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    log("timing", f"tile_schedule of {P} pairs over {n_tiles} tiles"
        + (f" ({n_pieces} pieces of at most {chunk})" if chunk else "")
        + f": kernel {dev:.4f} ms on the device (CUDA events over wrapper "
        f"calls {ms:.4f}), plain {plain_ms:.4f} ms, torch.sort(stable=True) "
        f"{library_ms:.4f} ms (device {library_dev}), bound "
        f"{bound_ms:.6f} ms (bytes: {nbytes / 1e3:.1f} KB)")
    return {"ms": dev, "ms_events": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "library_device_ms": library_dev,
            "library_call": "torch.sort(stable=True) of the keys (without "
                            "the piece list)"}


def time_slab(name, kernel, plain, args, view, sq8: bool):
    """K5 or K4 at the first batch's shape: kernel, plain, kernel again, one
    torch.bmm over slabs gathered and widened beforehand (the matvec alone,
    a part of the function), and the card's bound; the device work of the
    whole wrapper call (the schedule's launch included) and the schedule
    alone; in the log the tile reads that its schedule plans (``tile_runs``
    counts them from the sorted pairs; the kernel counts nothing). Returns
    (the kernel's entry, the schedule's timing)."""
    import torch

    from prefhetch_tpu_torch.ops import slab_scan as k45

    q, probe_ids = args[-2], args[-1]
    n_tiles, d = view.payload.shape[0], q.shape[1]
    chunk = k45.SQ8_CHUNK if sq8 else k45.SLAB_CHUNK
    ms = cuda_time_ms(lambda: kernel(*args))
    plain_ms = cuda_time_ms(lambda: plain(*args), iters=5, warmup=1)
    ms2 = cuda_time_ms(lambda: kernel(*args))
    dev = kernel_ms(lambda: kernel(*args),
                    "sq8_tiled_kernel" if sq8 else "slab_tiled_kernel",
                    min(ms, ms2))
    sched = time_schedule(probe_ids, n_tiles, 0 if sq8 else chunk)
    with_schedule = device_ms(lambda: kernel(*args))
    _, _, _, tile = k45.tile_runs(k45.tile_schedule(probe_ids, n_tiles)[0],
                                  chunk, aligned=not sq8)
    rows = view.sizes[tile].long()
    flat = probe_ids.reshape(-1).long()
    pair_rows = view.sizes[flat].long()
    distinct = view.sizes[torch.unique(flat)] > 0
    row_bytes = d * view.payload.element_size() + 4
    note = (f"; the wrapper call's device work with the schedule "
            f"{with_schedule} ms, the schedule kernel {sched['ms']:.4f} ms; "
            f"the schedule's plan (not read from the kernel): tile reads "
            f"{int((rows > 0).sum())} (one per pair: "
            f"{int((pair_rows > 0).sum())}; distinct tiles with rows "
            f"{int(distinct.sum())}), rows and norms read "
            f"{int(rows.sum()) * row_bytes / 1e6:.1f} MB (one per pair: "
            f"{int(pair_rows.sum()) * row_bytes / 1e6:.1f} MB)")
    if sq8:
        note += (f", code decodes {int(rows.sum()) * d / 1e6:.1f} M (one per "
                 f"pair: {int(pair_rows.sum()) * d / 1e6:.1f} M)")
    slabs = view.payload[flat].to(torch.float32)
    qrep = torch.repeat_interleave(q, probe_ids.shape[1], dim=0)[:, :, None]
    library_ms = cuda_time_ms(lambda: torch.bmm(slabs, qrep), iters=10)
    slab_mb = slabs.numel() * 4 / 1e6
    del slabs, qrep
    bound_ms, bound_by, mb, gflop = slab_bound(view, probe_ids, q, sq8)
    log("timing", f"{name} at nq={q.shape[0]} max_t={probe_ids.shape[1]} "
        f"T={view.tile} d={d} {view.payload.dtype}: kernel "
        f"{dev:.4f} ms on the device (CUDA events over wrapper calls "
        f"{ms:.4f} / {ms2:.4f}), plain {plain_ms:.4f} ms, torch.bmm on "
        f"pre-gathered f32 slabs ({slab_mb:.0f} MB, the matvec only) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{mb:.1f} MB, {gflop:.3f} GFLOP), {bound_ms / dev:.0%} of the "
        f"bound" + note)
    return {"ms": dev, "ms_events": min(ms, ms2),
            "ms_with_schedule": with_schedule, "schedule_ms": sched["ms"],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "torch.bmm f32 [B,T,d]x[B,d,1] on slabs "
                            "gathered and widened beforehand, the cross "
                            "term only (a partial function)"}, sched


def time_pq_probed(args, sm_mhz: float) -> dict:
    """K3 at the first batch's shape: kernel, plain, kernel again, the
    kernel once more on all-zero codes (every warp's 32 lookups of a term
    then read one entry: no bank conflicts; the gap is what the conflicts of
    random codes cost), and the card's bound: the larger of the bytes (the
    valid rows' codes of the distinct probed tiles, the bf16 tables of the
    queries and of the probed lists, the scalars of the probed (query, list)
    pairs, the indices, the f32 output) over the memory rate and the table
    lookups (M for every valid lane of every (query, slot) pair, bf16
    entries of 2 bytes out of shared memory, which delivers 128 bytes an SM
    a clock: 64 lookups) over the card's shared-memory rate. No one PyTorch
    call computes the function."""
    import torch

    from prefhetch_tpu_torch.ops import pq_onehot as k3

    codes, lutq, lutp, cadd, sizes, tile_list, tiles = args
    _, T, M = codes.shape
    nq, MK = lutq.shape
    max_t = tiles.shape[1]
    ms = cuda_time_ms(lambda: k3.pq_probed_distances(*args))
    plain_ms = cuda_time_ms(lambda: k3.pq_probed_distances_plain(*args),
                            iters=3, warmup=1)
    ms2 = cuda_time_ms(lambda: k3.pq_probed_distances(*args))
    dev = kernel_ms(lambda: k3.pq_probed_distances(*args), "pq_probed_kernel",
                    min(ms, ms2))
    flat_codes = (torch.zeros_like(codes),) + tuple(args[1:])
    dev_flat = kernel_ms(lambda: k3.pq_probed_distances(*flat_codes),
                         "pq_probed_kernel",
                         cuda_time_ms(lambda: k3.pq_probed_distances(
                             *flat_codes)))
    flat = tiles.reshape(-1).long()
    live = sizes[flat] > 0
    distinct = torch.unique(flat)
    rows = int(sizes[distinct].sum())
    lists_q = torch.unique(
        torch.arange(nq, device=flat.device).repeat_interleave(max_t)[live]
        * cadd.shape[1] + tile_list.long()[flat[live]])
    lists = torch.unique(tile_list.long()[flat[live]])
    nbytes = (rows * M + nq * MK * 2 + lists.numel() * MK * 2
              + lists_q.numel() * 4 + flat.numel() * 4 + distinct.numel() * 8
              + nq * max_t * T * 4)
    lookups = float(sizes[flat].sum()) * M
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t_b = nbytes / HBM_BYTES_S
    t_o = lookups * 2 / (n_sm * 128 * sm_mhz * 1e6)
    bound_ms = max(t_b, t_o) * 1e3
    bound_by = "bytes" if t_b >= t_o else "operations"
    log("timing", f"pq_probed_distances at nq={nq} max_t={max_t} (distinct "
        f"tiles {distinct.numel()}, lists {lists.numel()}) T={T} M={M} "
        f"ksub={MK // M}: kernel {dev:.4f} ms on the device (CUDA events "
        f"over wrapper calls {ms:.4f} / {ms2:.4f}), on all-zero codes (no "
        f"bank conflicts) {dev_flat:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library call none, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB = {t_b * 1e3:.4f} ms; {lookups / 1e6:.1f} M "
        f"lookups x 2 B over {n_sm} SMs x 128 B x {sm_mhz:.0f} MHz = "
        f"{t_o * 1e3:.4f} ms)")
    return {"ms": dev, "ms_events": min(ms, ms2),
            "ms_codes_all_zero": dev_flat, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library_call": "none: no single PyTorch call sums table "
                            "entries picked by code (torch.gather needs "
                            "the index spelled out per query, which is "
                            "what the plain version does in chunks)"}


VARIANTS = (
    # quant, scan, the kernel the variant's scan must launch, and the
    # kernels that must run beside it, each once a batch
    ("pq", "union", "pq_probed_distances", ()),
    ("sq8", "union", "slab_distances_sq8", ("tile_schedule",)),
    ("none", "slab", "slab_distances", ("tile_schedule",)),
)


def phase_variants(engine, data, queries, reset_counts, sm_mhz,
                   search_recall, base64, q64, hold: dict) -> dict:
    """The quantised and slab scan variants of the triage pipeline on the
    index and base of the main phase: for each, the tiled view, the kernel
    against its plain version at the first batch's own shapes, N_BATCHES
    query_pipeline steps with every launch count read around them, exact
    returned distances, recall, stage times and the kernel's timings.
    Returns {kernel name: its entry's keys for the kernels line}; ``hold``
    gets the first sq8 batch's K4 arguments under "sq8" and the first slab
    batch's K5 arguments under "slab"."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.index.tiling import build_tiled_view
    from prefhetch_tpu_torch.ops import slab_scan as k45
    from prefhetch_tpu_torch.ops.union_scan import pq_luts
    from prefhetch_tpu_torch.pipeline import default_tile, query_pipeline

    cfg = engine.config
    proto = cfg.protocol
    k = proto.k
    index = engine.index
    dev = index.device
    wrappers, plains = kernel_counters()
    schedule = {"launches": 0}            # the tile schedule's entry
    out = {"tile_schedule": schedule}
    for quant, scan, kernel_name, beside in VARIANTS:
        tag = f"quant={quant} scan={scan}"
        t0 = time.perf_counter()
        view = build_tiled_view(index, tile=default_tile(quant), quant=quant)
        torch.cuda.synchronize()
        log("variants", f"{tag}: tiled view in "
            f"{time.perf_counter() - t0:.1f} s; tiles={view.empty_tile} of "
            f"T={view.tile}, payload "
            f"{view.payload.numel() * view.payload.element_size() / 1e9:.3f}"
            f" GB {view.payload.dtype} "
            f"({view.payload.shape[2] * view.payload.element_size()} B a "
            f"vector)")

        def prepare(b):
            sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
            return query_pipeline(
                index, engine.base, queries[sl], nprobe=proto.nprobe,
                coarse_probe=proto.coarse_probe, k=k, quant=quant, scan=scan,
                device="cuda", view=view)

        # the kernel against its plain version at the first batch's shapes
        step, args, stats = prepare(0)
        payload, norms, sizes, _, _, q_t, tiles_t = args
        for chunk in (0, k45.SLAB_CHUNK):
            schedule["max_abs_err"] = max(
                schedule.get("max_abs_err", 0),
                check_schedule(f"variants/{tag} batch0", tiles_t,
                               view.payload.shape[0], chunk))
        if quant == "pq":
            lut_q, lut_p, cadd = pq_luts(index.centroids, index.codebooks,
                                         q_t, bool(index.params.by_residual))
            # the tables as the kernel reads them (the wrapper casts f32
            # tables to bf16 first; the function is the same)
            kargs = (payload, lut_q.to(torch.bfloat16),
                     lut_p.to(torch.bfloat16), cadd.contiguous(), sizes,
                     torch.from_numpy(view.tile_list_np).to(dev), tiles_t)
            err = check_pq_probed(f"variants/{tag} batch0", *kargs)
            times = time_pq_probed(kargs, sm_mhz)
            del lut_q, lut_p, cadd
        elif quant == "sq8":
            kargs = (payload, norms, sizes, view.sq_vmin, view.sq_scale, q_t,
                     tiles_t)
            err = check_slab(f"variants/{tag} batch0", k45.slab_distances_sq8,
                             k45.slab_distances_sq8_plain, kargs)
            times, sched = time_slab(
                "slab_distances_sq8", k45.slab_distances_sq8,
                k45.slab_distances_sq8_plain, kargs, view, True)
            schedule["ms_sq8_batch"] = sched["ms"]
            hold["sq8"] = kargs
        else:
            kargs = (payload, norms, sizes, q_t, tiles_t)
            err = check_slab(f"variants/{tag} batch0", k45.slab_distances,
                             k45.slab_distances_plain, kargs)
            times, sched = time_slab(
                "slab_distances", k45.slab_distances,
                k45.slab_distances_plain, kargs, view, False)
            schedule.update(sched)
            hold["slab"] = kargs
        step(*args)                       # warm-up, outside the counts
        torch.cuda.synchronize()

        # the variant's path, with launch counts read around it only
        reset_counts()
        ids_all, dists_all, prep_ms, step_ms = [], [], [], []
        for b in range(N_BATCHES):
            t0 = time.perf_counter()
            step, args, stats = prepare(b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            d_b, ids_b = step(*args)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            prep_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
            ids_all.append(ids_b.cpu().numpy())
            dists_all.append(d_b.cpu().numpy())
        launches = {n: w.launches for n, w in wrappers.items()}
        plain_calls = sum(p.calls for p in plains)
        log("variants", f"{tag}: query_pipeline x{N_BATCHES} of {NQ_BATCH} "
            f"queries: prepare (host: ranking, probe expansion, a union "
            f"where the scan takes one, upload) "
            f"{', '.join(f'{t:.1f}' for t in prep_ms)} ms, step "
            f"(device work, host clock) "
            f"{', '.join(f'{t:.2f}' for t in step_ms)} ms; tiles per query "
            f"{stats['tiles_per_query']:.0f}; launches {launches}, "
            f"plain-version calls {plain_calls}")
        want = {n: (N_BATCHES if n == kernel_name or n in beside else 0)
                for n in wrappers}
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches}, expected "
                                 f"{want}")
        if plain_calls != 0:
            raise AssertionError(f"{tag}: a plain version ran on the path")

        rep, dist_err = check_answers(
            tag, np.concatenate(ids_all), np.concatenate(dists_all), base64,
            q64, data["groundtruth"], k)
        log("variants", f"{tag}: recall@1 {rep.recall_1} recall@10 "
            f"{rep.recall_10} recall@100 {rep.recall_100} mrr@10 "
            f"{rep.mrr_10} (/search: recall@10 {search_recall.recall_10} "
            f"recall@100 {search_recall.recall_100}); returned distances = "
            f"exact float64 distances of the returned ids, max |err| "
            f"{dist_err}")

        # where a step's device time goes (the last batch's tensors)
        fns = stats["stage_fns"](args)
        stage_ms = {n: cuda_time_ms(f, iters=10) for n, f in fns.items()}
        stage_dev = {n: device_ms(f, iters=10) for n, f in fns.items()}
        log("variants", f"{tag}: stages of one step, CUDA events: "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in stage_ms.items())
            + "; device work per call (torch.profiler): "
            + ", ".join(f"{n} {t} ms" for n, t in stage_dev.items()))
        schedule["launches"] += launches["tile_schedule"]
        out[kernel_name] = {
            "launches": launches[kernel_name],
            "launches_per_batch": launches[kernel_name] / N_BATCHES,
            "path": f"query_pipeline({tag}) x{N_BATCHES}",
            "max_abs_err": err, **times,
        }
        del view, step, args, stats, fns, kargs, payload, norms, sizes
        torch.cuda.empty_cache()
    return out


# the dense-layout family's scans run in f32 over rows widened from their
# payload (bf16, f32 or uint8): the card's f32 rate bounds their products
def dense_bound(sizes, probes, row_bytes: int, other_bytes: int,
                flops: float):
    """The card's bound for a dense-layout search: each probed list's valid
    rows read once (``row_bytes`` a row: its payload and any stored norm),
    ``other_bytes`` beside them (queries, centroids, tables, the re-rank's
    base rows, outputs), the ``flops`` over the f32 rate → (bound_ms,
    bound_by, bytes, probed rows)."""
    import torch

    rows = int(sizes[torch.unique(probes)].sum())
    nbytes = rows * row_bytes + other_bytes
    t_b, t_o = nbytes / HBM_BYTES_S, flops / F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, rows)


def untied(d, rtol: float):
    """Lanes of an ascending [nq, k] row whose distance ties with no
    neighbour within ``rtol`` relative."""
    import numpy as np

    near = np.abs(np.diff(d, axis=1)) <= rtol * np.abs(d[:, 1:])
    tied = np.zeros(d.shape, bool)
    tied[:, 1:] |= near
    tied[:, :-1] |= near
    return ~tied


def scan_atol(q, norms) -> float:
    """The dense scans' f32 tolerance, as for the slab scans: 1e-5 of
    (max ‖q‖² + max ‖x‖²). Their distances are ‖q‖² + ‖x‖² − 2⟨q, x⟩ summed
    in f32 in different orders, so the error scales with the norms."""
    return 1e-5 * float((q.double() ** 2).sum(-1).max() + norms.max())


def phase_entry(engine, data, queries, reset_counts, smi, search_recall,
                base64, q64) -> None:
    """The dense-layout path on the card: entry.entry() at its own shape
    (the JAX contract, and the same step on the CPU); entry.query_step at
    the preset over the engine's bf16 list_recon; the four models (FlatL2,
    IVFFlat and IVFSQ8 assembled from the engine's own lists, IVFPQ on its
    list_recon and on its codes alone) with their searches' checks; the
    engine's dense coarse branch (SQ8, then PQ codes) through JSON
    /coarsesearch, byte-equal to the model's masked scan. Kernel launch
    counts are read around the whole phase: the dense family runs none (in
    the JAX package it is XLA, no Pallas)."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch import native
    from prefhetch_tpu_torch.entry import entry, query_step
    from prefhetch_tpu_torch.index.build import index_from_numpy, sq8_encode
    from prefhetch_tpu_torch.metrics import benchmark_results
    from prefhetch_tpu_torch.models import FlatL2, IVFFlat, IVFPQ, IVFSQ8
    from prefhetch_tpu_torch.ops.distances import rank_centroids
    from prefhetch_tpu_torch.ops.scan import coarse_scan_flat
    from prefhetch_tpu_torch.ops.topk import topk_select
    from prefhetch_tpu_torch.serve.handlers import Dispatcher

    t_phase = time.perf_counter()
    cfg = engine.config
    proto = cfg.protocol
    nprobe, cp, k = proto.nprobe, proto.coarse_probe, proto.k
    index = engine.index
    dev = index.device
    wrappers, plains = kernel_counters()
    reset_counts()

    # -- 1. entry() at its own shape, on the card and on the CPU ----------
    t0 = time.perf_counter()
    fn, args = entry(device=dev)
    if any(a.device != dev for a in args):
        raise AssertionError("entry(): example args not on the card")
    d_g, i_g = (t.cpu().numpy() for t in fn(*args))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if d_g.shape != (8, 32) or i_g.shape != (8, 32):
        raise AssertionError(f"entry(): shapes {d_g.shape} {i_g.shape}")
    if not np.isfinite(d_g).all() or (np.diff(d_g, axis=1) < -1e-3).any():
        raise AssertionError("entry(): distances not finite and ascending")
    if i_g.min() < 0:
        raise AssertionError("entry(): negative ids")
    d_c, i_c = (t.numpy() for t in fn(*(a.cpu() for a in args)))
    np.testing.assert_allclose(d_g, d_c, rtol=1e-5, atol=0)
    keep = untied(d_c, 1e-5)
    if not np.array_equal(i_g[keep], i_c[keep]):
        raise AssertionError("entry(): ids on the card differ from the "
                             "CPU's where no distances tie")
    log("entry", f"{smi}: entry() (tiny index built on the card, "
        f"{build_s:.1f} s with its first step): (8, 32) finite, ascending, "
        f"ids >= 0; the same query_step on the CPU: ids equal on all "
        f"{int(keep.sum())} lanes of {keep.size} whose distance ties with "
        f"no neighbour within 1e-5, max |distance "
        f"diff| {float(np.abs(d_g - d_c).max())}")
    del fn, args

    # -- 2. the step at the preset over the engine's index ----------------
    q_all = torch.from_numpy(queries).to(dev)
    batches = [q_all[b * NQ_BATCH:(b + 1) * NQ_BATCH]
               for b in range(N_BATCHES)]
    probes = [rank_centroids(q, index.centroids, nprobe)[1] for q in batches]
    recon = index.list_recon
    step_args = (index.centroids, recon, index.list_ids, index.list_sizes,
                 engine.base)

    def step(q):
        return query_step(*step_args, q, nprobe=nprobe, coarse_probe=cp,
                          k=k)

    def timed(fn_b):
        """fn_b(b) over the batches → (outputs, host ms a batch)."""
        outs, ms = [], []
        for b in range(N_BATCHES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = fn_b(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(o)
        return outs, ms

    def as_np(outs):
        """[(dists, ids)] a batch, tensors or numpy → (ids, dists)."""
        def cat(j):
            return np.concatenate([o[j].cpu().numpy() if torch.is_tensor(
                o[j]) else o[j] for o in outs])
        return cat(1), cat(0)

    step(batches[0])                      # warm-up
    outs, ms = timed(lambda b: step(batches[b]))
    ids, dists = as_np(outs)
    rep, err = check_answers("entry/step", ids, dists, base64, q64,
                             data["groundtruth"], k)
    dev_step = device_ms(lambda: step(batches[0]), iters=5, warmup=1)
    nl, lmax, d = recon.shape
    pair_rows = int(index.list_sizes[probes[0]].sum())
    bound = dense_bound(
        index.list_sizes, probes[0], d * recon.element_size(),
        NQ_BATCH * d * 4 + nl * d * 4 + NQ_BATCH * cp * d * 4
        + NQ_BATCH * k * 8,
        2.0 * d * (pair_rows + NQ_BATCH * (nl + cp)))
    gathered = NQ_BATCH * nprobe * lmax * d * recon.element_size()
    log("entry", f"{smi}: query_step at nprobe={nprobe} coarse_probe={cp} "
        f"k={k} over list_recon [{nl}, {lmax}, {d}] {recon.dtype} "
        f"(no list_norms: the norms from the payload, the whole index a "
        f"call), x{N_BATCHES} of {NQ_BATCH}: host clock "
        f"{', '.join(f'{t:.2f}' for t in ms)} ms a batch, device "
        f"{dev_step} ms a call (torch.profiler, all its device work); "
        f"bound {bound[0]:.4f} ms ({bound[1]}: {bound[2] / 1e6:.1f} MB, the "
        f"probed lists' {bound[3]} rows read once); the per-probe gather "
        f"reads {gathered / 1e6:.1f} MB (lmax rows a (query, probe)) and "
        f"the norm pass {recon.numel() * recon.element_size() / 1e6:.1f} MB")
    log("entry", f"query_step: recall@10 {rep.recall_10} recall@100 "
        f"{rep.recall_100} (/search: {search_recall.recall_10} / "
        f"{search_recall.recall_100}); returned distances = exact float64 "
        f"distances of the returned ids, max |err| {err}")

    # the step's coarse top-coarse_probe, cut to k: what IVFPQ.search
    # returns on the same list_recon
    coarse = []
    for q, p in zip(batches, probes):
        res = coarse_scan_flat(recon, index.list_ids, index.list_sizes, q, p)
        cd, pos = topk_select(res.distances, cp)
        coarse.append((cd[:, :k].cpu().numpy(),
                       torch.gather(res.ids, 1, pos)[:, :k].cpu().numpy()))
        del res
    del outs

    def model_run(tag, model, row_bytes, other_bytes, flops):
        """model.search over the batches, timed → (ids, dists) numpy."""
        model.nprobe = nprobe

        def search(b):
            return model.search(queries[b * NQ_BATCH:(b + 1) * NQ_BATCH],
                                k=k, coarse_probe=cp)

        search(0)                         # warm-up
        outs, ms = timed(search)
        dev_ms = device_ms(lambda: search(0), iters=5, warmup=1)
        bnd = dense_bound(index.list_sizes, probes[0], row_bytes,
                          other_bytes, flops)
        log("entry", f"{smi}: {tag}.search(k={k}, coarse_probe={cp}) at "
            f"nprobe={nprobe}, x{N_BATCHES} of {NQ_BATCH}: host clock "
            f"{', '.join(f'{t:.2f}' for t in ms)} ms a batch, device "
            f"{dev_ms} ms a call (torch.profiler); bound {bnd[0]:.4f} ms "
            f"({bnd[1]}: {bnd[2] / 1e6:.1f} MB)")
        return as_np(outs)

    qio = NQ_BATCH * d * 4 + nl * d * 4 + NQ_BATCH * k * 8
    flops_scan = 2.0 * d * (pair_rows + NQ_BATCH * nl)

    # -- 3. IVFPQ on list_recon: the step's coarse candidates ------------
    pq = IVFPQ(cfg.index, device=dev)
    pq.index = index
    ids, dists = model_run("IVFPQ", pq, d * recon.element_size() + 4, qio,
                           flops_scan)
    c_d = np.concatenate([c[0] for c in coarse])
    c_i = np.concatenate([c[1] for c in coarse])
    tol = scan_atol(q_all, index.list_norms)
    n_swap = 0
    for qi in range(ids.shape[0]):
        kth = dists[qi, -1]
        a = dict(zip(ids[qi].tolist(), dists[qi].tolist()))
        b = dict(zip(c_i[qi].tolist(), c_d[qi].tolist()))
        for x in a.keys() & b.keys():
            if abs(a[x] - b[x]) > tol:
                raise AssertionError(f"IVFPQ: query {qi} id {x}: distance "
                                     f"{a[x]} against the step's {b[x]}")
        for x, dx in [(x, a[x]) for x in a.keys() - b.keys()] + [
                (x, b[x]) for x in b.keys() - a.keys()]:
            if abs(dx - kth) > tol:
                raise AssertionError(f"IVFPQ: query {qi}: id {x} at "
                                     f"{dx} differs from the step's top-{k} "
                                     f"beyond a tie at {kth}")
            n_swap += 1
    log("entry", f"IVFPQ (list_recon): ids equal as sets to the step's "
        f"top-{cp} cut to {k} on every query ({n_swap // 2} swaps, each a "
        f"tie within {tol:.1f} at the {k}-th distance)")

    # -- 4. IVFPQ on its codes alone: the LUT scan (coarse_scan_pq) --------
    codes_idx = dataclasses.replace(index, list_recon=None, host_arrays={
        n: a for n, a in index.host_arrays.items() if n != "payload"})
    pq_lut = IVFPQ(cfg.index, device=dev)
    pq_lut.index = codes_idx
    res_r = pq.coarse_scan(batches[0], probes[0])
    res_l = pq_lut.coarse_scan(batches[0], probes[0])
    for f in ("ids", "mask", "counts"):
        if not torch.equal(getattr(res_r, f), getattr(res_l, f)):
            raise AssertionError(f"IVFPQ LUT scan: {f} differ from the "
                                 f"list_recon scan")
    # bf16 rounding of z: |‖q−ẑ‖² − ‖q−z‖²| ≤ 2‖q−z‖·e‖z‖ + (e‖z‖)², e =
    # 2^-9 (round to nearest), beside the scans' f32 tolerance
    e = 2.0 ** -9
    p0 = probes[0].long()
    zn = (index.list_norms[p0].reshape(NQ_BATCH, -1).double().sqrt()
          / (1 - e))
    m = res_r.mask
    dl = res_l.distances.double()
    allow = 2 * dl.clamp(min=0).sqrt() * e * zn + (e * zn) ** 2 + tol
    gap = (res_r.distances.double() - dl).abs()
    if bool((gap > allow)[m].any()):
        raise AssertionError("IVFPQ LUT scan: distances beyond bf16 rounding "
                             "of the list_recon scan's")
    log("entry", f"IVFPQ LUT scan (coarse_scan_pq, codes only) against the "
        f"list_recon scan at batch 0: ids, mask and counts equal; max "
        f"|distance diff| {float(gap[m].max()):.2f}, at most "
        f"{float((gap / allow)[m].max()):.3f} of the bf16 bound")
    del res_r, res_l, dl, gap, allow, zn, m
    M = index.codebooks.shape[0]
    ids, dists = model_run(
        "IVFPQ-LUT", pq_lut, M, qio + index.codebooks.numel() * 4,
        2.0 * M * pair_rows + NQ_BATCH * nprobe * index.codebooks.numel() * 2)
    if not np.isfinite(dists).all() or (np.diff(dists, axis=1) < 0).any():
        raise AssertionError("IVFPQ-LUT: distances not finite and ascending")
    rep_l = benchmark_results(ids, data["groundtruth"], k=k)
    log("entry", f"IVFPQ-LUT: ADC distances only (no re-rank): recall@10 "
        f"{rep_l.recall_10} recall@100 {rep_l.recall_100} (no limit)")

    # -- 5. FlatL2: brute force over the base -----------------------------
    base_np = data["base"]
    flat = FlatL2(d, device=dev)
    flat.add(base_np)

    def flat_search(b):
        return flat.search(queries[b * NQ_BATCH:(b + 1) * NQ_BATCH], k)

    flat_search(0)
    outs, t_flat = timed(flat_search)
    dev_flat = device_ms(lambda: flat_search(0), iters=5, warmup=1)
    ids, dists = as_np(outs)
    rep_f, err = check_answers("entry/FlatL2", ids, dists, base64, q64,
                               data["groundtruth"], k)
    if rep_f.recall_10 != 1.0 or rep_f.recall_100 != 1.0:
        raise AssertionError(f"FlatL2: recall {rep_f.recall_10} / "
                             f"{rep_f.recall_100}, not 1.0")
    nb = base_np.shape[0]
    fb = nb * d * 4 + NQ_BATCH * d * 4 + NQ_BATCH * k * 8
    ff = 2.0 * d * nb * NQ_BATCH
    flat_bound = max(fb / HBM_BYTES_S, ff / F32_FLOPS) * 1e3
    log("entry", f"{smi}: FlatL2.search(k={k}) over {nb} rows, "
        f"x{N_BATCHES} of {NQ_BATCH}: host clock "
        f"{', '.join(f'{t:.2f}' for t in t_flat)} ms a batch, device "
        f"{dev_flat} ms a call (torch.profiler); bound {flat_bound:.4f} ms "
        f"({'bytes' if fb / HBM_BYTES_S >= ff / F32_FLOPS else 'operations'}"
        f": {fb / 1e6:.1f} MB, {ff / 1e9:.2f} GFLOP f32); recall@10 "
        f"{rep_f.recall_10} recall@100 {rep_f.recall_100}, distances exact "
        f"(max |err| {err})")
    del flat, outs
    torch.cuda.empty_cache()

    # -- 6. IVFFlat and IVFSQ8, assembled from the engine's lists ----------
    lids = index.list_ids.cpu().numpy()
    valid = lids >= 0
    rows = lids[valid]
    arrays = {"centroids": index.centroids.cpu().numpy(), "list_ids": lids,
              "list_sizes": index.list_sizes.cpu().numpy()}
    t0 = time.perf_counter()
    vecs = np.zeros(lids.shape + (d,), np.float32)
    vecs[valid] = base_np[rows]
    norms = np.zeros(lids.shape, np.float32)
    norms[valid] = (base_np.astype(np.float64) ** 2).sum(-1)[rows]
    p_flat = dataclasses.replace(cfg.index, pq_m=0)
    ivf = IVFFlat(p_flat, device=dev)
    ivf.index = index_from_numpy(dict(arrays, list_vectors=vecs,
                                      list_norms=norms), p_flat, dev)
    del vecs, norms
    log("entry", f"IVFFlat index from the engine's lists: "
        f"{time.perf_counter() - t0:.1f} s, list_vectors "
        f"{ivf.index.list_vectors.numel() * 4 / 1e9:.3f} GB f32 "
        f"(lmax {lmax})")
    ids, dists = model_run("IVFFlat", ivf, d * 4 + 4, qio, flops_scan)
    rep_v, err = check_answers("entry/IVFFlat", ids, dists, base64, q64,
                               data["groundtruth"], k)
    log("entry", f"IVFFlat: recall@10 {rep_v.recall_10} recall@100 "
        f"{rep_v.recall_100}; distances exact (max |err| {err})")
    del ivf
    torch.cuda.empty_cache()

    # the index build's SQ8 quantizer, trained on the smoke's train set
    codes8, vmin, scale = sq8_encode(data["train"], base_np)
    list_sq = np.zeros(lids.shape + (d,), np.uint8)
    list_sq[valid] = codes8[rows]
    p_sq8 = dataclasses.replace(cfg.index, pq_m=0, quantizer="sq8")
    sq8 = IVFSQ8(p_sq8, device=dev)
    sq8_idx = index_from_numpy(dict(arrays, list_sq=list_sq, sq_vmin=vmin,
                                    sq_scale=scale), p_sq8, dev)
    sq8.index = sq8_idx
    del list_sq
    ids, dists = model_run("IVFSQ8", sq8, d, qio, flops_scan)
    if not np.isfinite(dists).all() or (np.diff(dists, axis=1) < 0).any():
        raise AssertionError("IVFSQ8: distances not finite and ascending")
    dec = (torch.from_numpy(vmin).to(dev, torch.float64)
           + (torch.from_numpy(codes8).to(dev)[torch.from_numpy(ids).to(
               dev).long()].double() + 0.5)
           * torch.from_numpy(scale).to(dev, torch.float64))
    exact = ((dec - q64[:, None]) ** 2).sum(-1)
    tol8 = scan_atol(q_all, (dec ** 2).sum(-1))
    err8 = float((torch.from_numpy(dists).to(dev) - exact).abs().max())
    if err8 > tol8:
        raise AssertionError(f"IVFSQ8: distances {err8} from the decoded "
                             f"vectors' (tolerance {tol8})")
    rep_s = benchmark_results(ids, data["groundtruth"], k=k)
    if abs(rep_s.recall_100 - rep_v.recall_100) > 0.02:
        raise AssertionError(f"IVFSQ8: recall@100 {rep_s.recall_100}, "
                             f"IVFFlat's {rep_v.recall_100}")
    log("entry", f"IVFSQ8: distances = the decoded vectors' float64 "
        f"distances within {tol8:.1f} (max |err| {err8:.3f}); recall@10 "
        f"{rep_s.recall_10} recall@100 {rep_s.recall_100} (IVFFlat "
        f"{rep_v.recall_100}, within 0.02)")
    del dec, exact, codes8

    # -- 7. the engine's dense coarse branch: JSON /coarsesearch ----------
    eng = type(engine)(cfg, device=dev)
    for tag, idx, model in (("IVFSQ8", sq8_idx, sq8),
                            ("PQ codes", codes_idx, pq_lut)):
        eng.set_index(idx, base_np)
        if eng._tiled_view is not None:
            raise AssertionError(f"engine ({tag}): a tiled view was built")
        disp = Dispatcher(eng)
        req_ms, nbytes = [], 0
        for b, (q, p) in enumerate(zip(batches, probes)):
            sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
            body = json.dumps({"preciseQuery": queries[sl].tolist(),
                               "nearestCentroidIndexes":
                                   p.cpu().numpy().tolist()}).encode()
            t0 = time.perf_counter()
            status, _, resp = disp.handle("POST", "/coarsesearch", {},
                                              body)
            req_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"/coarsesearch ({tag}): {status} "
                                     f"{resp[:200]!r}")
            res = model.coarse_scan(q, p)
            mask = res.mask.cpu().numpy().reshape(-1)
            want = (b'{"coarseDistanceScores":' + native.json_encode_f32(
                res.distances.cpu().numpy().reshape(-1)[mask])
                + b',"coarseVectorIndexes":' + native.json_encode_i64(
                    res.ids.cpu().numpy().reshape(-1)[mask].astype(
                        np.int64))
                + b',"listSizesPerQuery":' + native.json_encode_i64(
                    res.counts.cpu().numpy().astype(np.int64)) + b"}")
            if resp != want:
                raise AssertionError(f"/coarsesearch ({tag}) batch {b}: "
                                     f"not byte-equal to {type(model).__name__}"
                                     f".coarse_scan under its mask")
            nbytes += len(resp)
            del res
        log("entry", f"{smi}: engine dense branch ({tag}, no tiled view): "
            f"JSON /coarsesearch x{N_BATCHES} of {NQ_BATCH} queries "
            f"byte-equal to {type(model).__name__}.coarse_scan under its "
            f"mask (scores, ids, listSizesPerQuery); host clock "
            f"{', '.join(f'{t:.1f}' for t in req_ms)} ms a request, "
            f"{nbytes / N_BATCHES / 1e6:.1f} MB a response")
    del eng, disp, sq8, sq8_idx, pq_lut, codes_idx
    torch.cuda.empty_cache()

    launches = {n: w.launches for n, w in wrappers.items()}
    plain_calls = sum(p.calls for p in plains)
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"the dense family launched {launches}, plain "
                             f"versions {plain_calls}: it runs no kernel")
    log("entry", f"launches over the phase {launches}, plain-version calls "
        f"{plain_calls} (the dense family is plain PyTorch, as it is XLA "
        f"in the JAX package); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def time_k1_headline(index, queries, nprobe: int, smi) -> dict:
    """K1 alone at the bench headline's shape (PERF.md § 4, core): the
    engine's index in tiles of 1,024, all N_BATCHES x NQ_BATCH queries in
    one batch at ``nprobe``, the union of their probed tiles. Held against
    its plain version first (check_k1_at_bench's tolerances); then its
    device time (torch.profiler; CUDA events beside it), the torch.matmul
    cross term at the same shape and the card's bound."""
    import numpy as np
    import torch

    from prefhetch_tpu_torch.index.tiling import build_tiled_view
    from prefhetch_tpu_torch.ops import union_scan_min as usm
    from prefhetch_tpu_torch.ops.distances import rank_centroids
    from prefhetch_tpu_torch.ops.union_scan import union_probe_tiles

    view = build_tiled_view(index, tile=1024)
    q = torch.from_numpy(queries).to(index.device)
    _, probes = rank_centroids(q, index.centroids, nprobe)
    tiles, _ = view.expand_probes(probes.cpu().numpy())
    union_np, _ = union_probe_tiles(tiles, view.empty_tile)
    union = torch.from_numpy(union_np.astype(np.int32)).to(index.device)
    args = (view.payload, view.norms, view.sizes, q, union)
    checked = check_k1_at_bench("timing/headline", args)

    def k1():
        return usm.union_scan_min(*args)

    ev = cuda_time_ms(k1)
    dev_ms = kernel_ms(k1, "union_scan_min_bf16_kernel", ev)
    real = union[view.sizes[union.long()] > 0].long()
    slab_t = view.payload[real].reshape(-1, D).T.contiguous()
    qc = q.to(view.payload.dtype)
    lib_ms = cuda_time_ms(lambda: torch.matmul(qc, slab_t))
    lib_dev = device_ms(lambda: torch.matmul(qc, slab_t))
    bound_ms, bound_by, nbytes, flops, rows = k1_bound(
        view.payload, view.sizes, union, q.shape[0])
    U, T = union.shape[0], view.tile
    log("timing", f"{smi}: union_scan_min at the bench headline's shape "
        f"[U {U}, nq {q.shape[0]}, T {T}] (real tiles {len(real)}, valid "
        f"rows {rows}, d={D}): kernel {dev_ms:.4f} ms on the device "
        f"({nbytes / dev_ms / 1e6:.0f} GB/s of the bound's bytes; CUDA "
        f"events over wrapper calls {ev:.4f}), torch.matmul cross term "
        f"{lib_ms:.4f} ms (device {lib_dev}), bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.1f} MB, of it the d2 write "
        f"{U * q.shape[0] * T * 2 / 1e6:.1f} MB; {flops / 1e9:.2f} GFLOP)")
    return {**checked, "ms": dev_ms, "ms_events": ev, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}

def phase_ablation(k4args, k5args, tb, nbatch: int) -> None:
    """K4 and K5 on the first sq8 and slab batches' own arguments and K2 at
    the request's shape under every variant of tools/kernel_ablation.py."""
    import torch

    from prefhetch_tpu_torch.ops import slab_scan as k45
    from prefhetch_tpu_torch.tools import kernel_ablation as ka

    def timer(fn, kernel):
        ms = device_ms(fn, kernel)
        if ms is None:
            raise AssertionError(f"the profiler saw no {kernel} launch")
        return ms

    kernels = {"K4": (k45.slab_distances_sq8, k45.slab_distances_sq8_plain,
                      k4args),
               "K5": (k45.slab_distances, k45.slab_distances_plain, k5args)}
    for k, (_, _, kargs) in kernels.items():
        probe_ids = kargs[-1]
        flat = probe_ids.reshape(-1).long()
        live = flat[kargs[2][flat] > 0]
        tiles = int(torch.unique(live).numel())
        which = {"K4": "quant=sq8", "K5": "scan=slab"}[k]
        log("ablation", f"{k} on the first {which} batch: "
            f"{probe_ids.shape[0]} queries x {probe_ids.shape[1]} "
            f"slots, {live.numel()} pairs on tiles with rows, {tiles} "
            f"distinct tiles ({live.numel() / tiles:.2f} pairs a tile)")

    def check(k, v):
        kernel, plain, kargs = kernels[k]
        check_slab(f"ablation/{k} {v}", kernel, plain, kargs)

    k4, k5 = ka.ablate_slab(k4args, k5args, timer, check)
    for k, times in (("K4", k4), ("K5", k5)):
        log("ablation", f"{k} device ms a launch: " + ", ".join(
            f"{v} {t:.4f}" for v, t in times.items()))
    k2 = ka.ablate_k2(tb, nbatch, timer)
    log("ablation", f"K2 forward transform of {nbatch} polynomials, device "
        f"ms a launch: " + ", ".join(f"{v} {t:.4f}" for v, t in k2.items()))


HTTP_THREADS, HTTP_PER_THREAD = 64, 20
HTTP_PROC_NBASE, HTTP_PROC_NTRAIN = 100_000, 50_000


def in_process(cfg, disp):
    """The same client with in-process Dispatcher calls for its transport:
    the reference run of the same stages."""
    from prefhetch_tpu_torch.client.pipeline import ClientPipeline

    def send(method, route, body):
        status, _, out = disp.handle(method, "/" + route, {}, body)
        if status != 200:
            raise AssertionError(f"in-process {method} /{route}: "
                                 f"{status} {out[:300]!r}")
        return out

    return ClientPipeline(cfg, send=send)


def run_stages(client, queries):
    """Stages 2-8 of the reference's client on ``queries``. Returns (final
    ids [nq, K], their vectors, precise scores [nq, CP], the candidates
    they score, the sorted coarse candidates, list sizes, stage ms)."""
    ms = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    cents = timed("2 GET /query", client.get_centroids)
    _, order = timed("3 sort centroids", client.sort_nearest_centroids,
                     queries, cents)
    cs, ci, sizes = timed("4 POST /coarsesearch", client.get_coarse_scores,
                          order, queries)
    sorted_coarse = timed("5 sort candidates",
                          client.compute_nearest_coarse_vectors, cs, ci,
                          sizes)
    ps, cand = timed("6 POST /precisesearch", client.get_precise_scores,
                     sorted_coarse, queries)
    _, sorted_ids = timed("7 sort precise",
                          client.compute_nearest_precise_vectors, ps, cand)
    vecs, top = timed("8 POST /precise-vector-pir",
                      client.get_precise_vectors_pir, sorted_ids)
    return top, vecs, ps, cand, sorted_coarse, order, sizes, ms


def http_recall(tag, ids, groundtruth, k):
    from prefhetch_tpu_torch.metrics import benchmark_results

    rep = benchmark_results(ids, groundtruth[: len(ids)], k=k)
    log("http", f"{tag}: recall@1 {rep.recall_1} recall@10 {rep.recall_10} "
        f"recall@100 {rep.recall_100} mrr@10 {rep.mrr_10}")
    if rep.recall_10 < RECALL10_MIN or rep.recall_100 < RECALL100_MIN:
        raise AssertionError(
            f"{tag}: recall@10 {rep.recall_10} / recall@100 "
            f"{rep.recall_100} below {RECALL10_MIN} / {RECALL100_MIN}")
    return rep


def http_json_protocol(cfg, addr, disp, engine, data, queries):
    """Step 2: the reference's protocol over JSON, against the same stages
    run in-process. Returns the HTTP run's sorted coarse candidates and
    probes for the steps after it."""
    import urllib.request

    import numpy as np
    import torch

    from prefhetch_tpu_torch.client.pipeline import ClientPipeline

    client = ClientPipeline(cfg, addr)     # records bytes and wire ms a route
    top, vecs, ps, cand, sorted_coarse, order, sizes, ms = run_stages(
        client, queries)
    top_r, _, ps_r, cand_r, *_ = run_stages(in_process(cfg, disp), queries)
    if not (np.array_equal(top, top_r) and np.array_equal(cand, cand_r)):
        raise AssertionError("the stages over HTTP chose other ids than "
                             "the same stages in-process")
    np.testing.assert_array_equal(ps, ps_r)
    dev = engine.device
    base64 = torch.from_numpy(data["base"]).to(dev, torch.float64)
    q64 = torch.from_numpy(queries).to(dev, torch.float64)
    exact = ((base64[torch.from_numpy(cand).to(dev)] - q64[:, None]) ** 2
             ).sum(-1).cpu().numpy()
    np.testing.assert_allclose(ps, exact, rtol=1e-6)
    if not np.array_equal(vecs, data["base"][top]):
        raise AssertionError("/precise-vector-pir vectors differ from "
                             "base[ids]")
    log("http", f"JSON protocol, {len(queries)} queries over HTTP (stages "
        f"2-8, host clock): " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in ms.items()))
    with urllib.request.urlopen(addr + "stats", timeout=60) as r:
        served = json.loads(r.read())
    log("http", "  per route: response bytes, wire ms (request to response "
        "read), server ms (Dispatcher, /stats mean): " + "; ".join(
            f"{k} {client.bytes[k]:,} B, {client.wire_ms[k]:.1f}, "
            f"{served[('GET /' if k == 'query' else 'POST /') + k]['mean_ms']}"
            for k in client.bytes))
    log("http", f"  {sizes.mean():.0f} candidates a query (min "
        f"{sizes.min()}); "
        f"final ids = in-process, precise = float64 (rtol 1e-6), vectors = "
        f"base[ids] bit for bit")
    http_recall("JSON protocol", top, data["groundtruth"], cfg.protocol.k)
    return sorted_coarse, order[:, :cfg.protocol.nprobe], sizes


def http_binary(cfg, addr, engine, data, queries, probes, sizes):
    """Step 3: the binary wire — tile table, the tiled q16 coarse kind with
    ids resolved from the cached table, client selection, binary
    /precisesearch."""
    import numpy as np

    from prefhetch_tpu_torch.client.binwire import BinWireClient
    from prefhetch_tpu_torch.utils import wire_bin

    cp, k = cfg.protocol.coarse_probe, cfg.protocol.k
    client = BinWireClient(addr)
    try:
        t0 = time.perf_counter()
        client.fetch_tiletable()
        t1 = time.perf_counter()
        ids, qd, _, _ = client.coarse_round(queries, probes)
        t2 = time.perf_counter()
        valid = qd != wire_bin.Q16_PAD
        if not np.array_equal(valid.sum(1), sizes):
            raise AssertionError("the tiled kind's valid lanes differ from "
                                 "listSizesPerQuery")
        list_ids = engine.index.list_ids.cpu().numpy()
        for r in range(len(queries)):
            if not np.isin(ids[r][valid[r]], list_ids[probes[r]]).all():
                raise AssertionError(f"query {r}: a tile-table id is not "
                                     f"in a probed list")
        t3 = time.perf_counter()
        cand = client.coarse_topk(queries, probes, cp)
        t4 = time.perf_counter()
        scores = client.precise(queries, cand)
        t5 = time.perf_counter()
    finally:
        client.close()
    order = np.argsort(scores, axis=1, kind="stable")[:, :k]
    final = np.take_along_axis(cand, order, axis=1)
    log("http", f"binary wire (host clock): GET /tiletable "
        f"{(t1 - t0) * 1e3:.1f} ms ({client.tile_ids.nbytes:,} B of ids), "
        f"tiled /coarsesearch (q16) {(t2 - t1) * 1e3:.1f} ms "
        f"({qd.nbytes:,} B of q16 lanes), the same + client top-{cp} "
        f"{(t4 - t3) * 1e3:.1f} ms, binary /precisesearch "
        f"{(t5 - t4) * 1e3:.1f} ms; every valid lane's id is in a probed "
        f"list")
    http_recall("binary wire", final, data["groundtruth"], k)


def http_concurrency(cfg, srv, disp, queries, probes, smi):
    """Step 4: HTTP_THREADS threads, each sending HTTP_PER_THREAD one-query
    binary /search requests on a keep-alive connection. Returns (q/s, p50
    ms, p99 ms, fused engine calls, waves, rows a wave, K1 launches)."""
    import http.client
    import threading

    import numpy as np

    from prefhetch_tpu_torch.ops import union_scan_min as usm
    from prefhetch_tpu_torch.utils import wire_bin

    k = cfg.protocol.k
    nq = len(queries)
    reqs = [wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
        queries[i:i + 1], probes[i:i + 1], np.array([k], np.uint32)])
        for i in range(nq)]
    hdr = {"content-type": wire_bin.CONTENT_TYPE}
    single = [wire_bin.decode(disp.handle("POST", "/search", hdr, r)[2])[1]
              for r in reqs]
    n_req = HTTP_THREADS * HTTP_PER_THREAD
    results = [None] * n_req
    start = threading.Barrier(HTTP_THREADS)

    def client(t):
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        try:
            start.wait(timeout=120)
            for j in range(HTTP_PER_THREAD):
                slot = t * HTTP_PER_THREAD + j
                t0 = time.perf_counter()
                c.request("POST", "/search", body=reqs[slot % nq],
                          headers={"Content-Type": wire_bin.CONTENT_TYPE})
                r = c.getresponse()
                body = r.read()
                results[slot] = (r.status, body,
                                 (time.perf_counter() - t0) * 1e3)
        finally:
            c.close()

    wrappers, plains = kernel_counters()
    for w in wrappers.values():
        w.launches = 0
    for p in plains:
        p.calls = 0
    calls0 = srv.group_calls["fused"]
    tm0 = srv.snapshot()
    def burst():
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(HTTP_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        return threads

    t0 = time.perf_counter()
    threads = burst()
    wall = time.perf_counter() - t0
    k1 = usm.union_scan_min.launches
    fused = srv.group_calls["fused"] - calls0
    tm1 = srv.snapshot()
    tm = {key: tm1[key] - tm0[key] for key in (
        "waves", "rows", "decode_s", "dispatch_s", "queue_s", "resolve_s",
        "encode_s", "poll_s")}
    waves, rows = tm["waves"], tm["rows"]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a /search client thread did not finish")
    failed = [r for r in results if r is None or r[0] != 200]
    if failed:
        raise AssertionError(f"{len(failed)} of {n_req} /search requests "
                             f"failed")
    differ = 0
    for slot, (_, body, _) in enumerate(results):
        ids, dists = wire_bin.decode(body)[1]
        want_ids, want_d = single[slot % nq]
        differ += not (np.array_equal(ids, want_ids)
                       and np.array_equal(dists, want_d))
    if differ:
        raise AssertionError(f"{differ} of {n_req} answers differ from the "
                             f"single-request answers")
    if k1 != fused or fused < 1:
        raise AssertionError(f"K1 launched {k1} times for {fused} engine "
                             f"calls of the waves")
    if sum(p.calls for p in plains) != 0:
        raise AssertionError("a plain version ran on the HTTP path")
    lat = np.array([r[2] for r in results])
    qps = n_req / wall
    p50, p99 = (float(np.percentile(lat, p)) for p in (50, 99))
    log("http", f"POST /search x{n_req} ({HTTP_THREADS} threads x "
        f"{HTTP_PER_THREAD}, one query, k={k}, keep-alive) on the native "
        f"frontend: {qps:.1f} q/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms "
        f"(host clock, {wall:.2f} s), {waves} waves, "
        f"{rows / max(waves, 1):.1f} rows a wave, K1 launches {k1} = "
        f"engine calls {fused}; answers = single-request answers; {smi}")
    # K1 against its plain version at the shapes this path gave it: the
    # engine does not pad, so a wave runs K1 at its own row count (these
    # launches come after the counts were read)
    engine = srv.engine
    view = engine._tiled_view
    for rows_k1 in sorted({1, max(1, round(rows / max(waves, 1))),
                           srv.snapshot()["max_batch"]}):
        sel = np.arange(rows_k1) % nq
        _, q_w, union_w, _, _ = engine._tiled_batch_prep(probes[sel],
                                                         queries[sel])
        check_union_scan_min(f"http/wave nq={rows_k1}", view.payload,
                             view.norms, view.sizes, q_w, union_w,
                             min_atol=4.0)
    per = {key: 1e3 * tm[key] / max(waves, 1) for key in (
        "decode_s", "dispatch_s", "queue_s", "resolve_s", "encode_s",
        "poll_s")}
    log("http", f"  a wave, mean ms (thread seconds; the 3 resolvers' add "
        f"up): " + ", ".join(f"{key[:-2]} {v:.2f}" for key, v in
                             per.items())
        + f"; at most {tm1['resolving_max']} resolvers inside a "
        f"resolver at once; wall per wave {1e3 * wall / max(waves, 1):.2f}")
    wall_p, busy_p, prof = profile_device(
        f"the same {n_req} /search requests again under the profiler",
        burst)
    k1_ms = sum(us for us, key, _ in prof if "union_scan_min" in key) / 1e3
    if prof:
        log("profile", f"  K1 {k1_ms:.4f} ms of the device's busy "
            f"{busy_p:.3f} ms; device busy {100 * busy_p / wall_p:.1f}% of "
            f"the burst's {wall_p:.1f} ms")
    return {"qps": qps, "p50_ms": p50, "p99_ms": p99, "waves": waves,
            "fused_calls": fused, "rows_per_wave": rows / max(waves, 1),
            "k1_launches": k1, "requests": n_req}


def http_encrypted(cfg, addr, engine, queries, sorted_coarse):
    """Step 5: one "full", one "packed" and one CKKS "combined" (config 3's
    HE parameters) /encryptedsearch request of the reference client's
    stage 6 over HTTP, decrypted by the client: BFV exactly, CKKS within
    the combined response's own precision (CKKS_COMBINED_MAX_ABS).
    Returns K2's launches per request by wire."""
    import numpy as np

    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.client.pipeline import ClientPipeline
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s

    import torch

    L = cfg.he.n_limbs
    n_elts = len(engine.he_service.ctx.extraction_elts(cfg.he.n, D))
    want = {"full": 2 * L,
            "packed": L + 2 * L + 2 * (L + 1) * n_elts + 2 * L,
            "ckks combined": 56}
    per_request, rows = {}, []
    k2s.ntt4_step_plain.calls = 0
    for mode in ("full", "packed", "ckks combined"):
        he = (ckks_he() if mode.startswith("ckks")
              else dataclasses.replace(cfg.he, resp_mod=mode))
        client = ClientPipeline(dataclasses.replace(cfg, he=he), addr)
        hec = HEClient(he)
        before = k2.ntt4_transform.launches
        t0 = time.perf_counter()
        dists, cand = client.get_encrypted_precise_scores(
            sorted_coarse, queries, he_client=hec)
        ms = (time.perf_counter() - t0) * 1e3
        per_request[mode] = k2.ntt4_transform.launches - before
        if mode.startswith("ckks"):
            cand_rows = engine.base[torch.from_numpy(cand).to(
                engine.device)].cpu().numpy()
            rel, abs_ = ckks_errors(dists, cand_rows, queries)
            if abs_ > CKKS_COMBINED_MAX_ABS:
                raise AssertionError(f"{mode} over HTTP: max |distance "
                                     f"error| {abs_} above "
                                     f"{CKKS_COMBINED_MAX_ABS}")
            note = (f", max |distance error| {abs_:.1f} (relative "
                    f"{rel:.6f})")
        else:
            plain = engine.precise_search(queries, cand)
            if not np.array_equal(dists, plain):
                raise AssertionError(f"{mode} over HTTP: decrypted "
                                     f"distances differ from precise_search")
            note = ""
        rows.append(f"{mode} {ms:.1f} ms (wire "
                    f"{client.wire_ms['encryptedsearch']:.1f} ms, "
                    f"{client.bytes['encryptedsearch']:,} B down), K2 "
                    f"launches {per_request[mode]}{note}")
    log("http", f"POST /encryptedsearch over HTTP, {len(queries)} queries "
        f"(client encrypt + request + decrypt, host clock; wire = request "
        f"sent to response read): "
        + "; ".join(rows) + f" (expected {want}); BFV distances = "
        f"precise_search, CKKS within {CKKS_COMBINED_MAX_ABS:.0f}")
    if per_request != want:
        raise AssertionError(f"K2 launches per HTTP request {per_request}, "
                             f"expected {want}")
    if k2s.ntt4_step_plain.calls:
        raise AssertionError("K2's plain version ran on the HTTP path")
    return per_request


def http_two_processes(cfg, device: str, smi: str):
    """Step 6: the port's server and driver as two processes on a 100K
    SIFT-style dataset at the preset's widths; the server builds its index
    on ``device`` (the card). Then the same with ``serve.main --shard``
    (the index warm-loaded, then sharded over every visible card): the
    driver's recall/MRR block must be the unsharded server's."""
    import socket

    from prefhetch_tpu_torch.data.synthetic import write_sift_style_dataset

    work = os.path.join(ROOT, "prefhetch_tpu_torch", "build", "smoke_http")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_sift_style_dataset(
        work, prefix="sift100k", nbase=HTTP_PROC_NBASE,
        ntrain=HTTP_PROC_NTRAIN, nquery=NQ_BATCH, d=D, n_clusters=600,
        gt_k=100, seed=21)
    pcfg = dataclasses.replace(
        cfg, nbase=HTTP_PROC_NBASE, train_path=paths["train"],
        base_path=paths["base"], query_path=paths["query"],
        groundtruth_path=paths["groundtruth"])
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(pcfg.to_json())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t_data = time.perf_counter() - t0
    try:
        blocks = [serve_and_drive(cfg_path, work, port, device, env, t_data,
                                  smi, extra) for extra in ([], ["--shard"])]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if blocks[0] != blocks[1]:
        raise AssertionError(f"serve.main --shard: recall/MRR {blocks[1]} "
                             f"differ from the unsharded server's "
                             f"{blocks[0]}")
    log("shard", "serve.main --shard (the index warm-loaded and sharded "
        "over every visible card) answered the client driver with the "
        "unsharded server's recall/MRR block")


def serve_and_drive(cfg_path, work, port, device, env, t_data, smi, extra):
    """One server process (``serve.main`` with ``extra`` arguments) and the
    client driver against it → the driver's recall and MRR lines."""
    import re
    import urllib.request

    log_path = os.path.join(work, "server.log")
    with open(log_path, "wb") as logf:
        srv = subprocess.Popen(
            [sys.executable, "-m", "prefhetch_tpu_torch.serve.main",
             "--config", cfg_path, "--port", str(port), "--index-dir", work,
             "--frontend", "native", "--device", device] + extra,
            stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    ok = False
    try:
        t0 = time.perf_counter()
        deadline = t0 + 300
        while True:
            if srv.poll() is not None:
                raise AssertionError(f"the server exited with "
                                     f"{srv.returncode}")
            if time.perf_counter() > deadline:
                raise AssertionError("the server did not answer /healthz "
                                     "in 300 s")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.25)
        t_up = time.perf_counter() - t0
        tag = "shard" if extra else "http"
        how = f" (serve.main {' '.join(extra)})" if extra else ""
        blocks = set()
        for run in ("first", "warm"):
            t0 = time.perf_counter()
            drv = subprocess.run(
                [sys.executable, "-m", "prefhetch_tpu_torch.client.driver",
                 "--config", cfg_path, "--server",
                 f"http://127.0.0.1:{port}/"],
                capture_output=True, text=True, cwd=ROOT, env=env,
                timeout=300)
            t_drv = time.perf_counter() - t0
            out = drv.stdout + drv.stderr
            if drv.returncode != 0:
                raise AssertionError(f"the client driver exited with "
                                     f"{drv.returncode}:\n{out[-3000:]}")
            taken = re.search(r"Time taken for client queries = (\d+) us "
                              r"\((\d+) ms\)", out)
            rec = re.search(r"Recall@1 = \S+, Recall@10 = \S+, "
                            r"Recall@100 = \S+", out)
            mrr = re.search(r"MRR@1 = \S+, MRR@10 = \S+, MRR@100 = \S+",
                            out)
            if not (taken and rec and mrr):
                raise AssertionError(f"no timing or recall/MRR block in the "
                                     f"driver's output:\n{out[-3000:]}")
            blocks.add((rec.group(0), mrr.group(0)))
            log(tag, f"{smi}: two processes{how}, {HTTP_PROC_NBASE:,} x {D} "
                f"SIFT-style (data {t_data:.1f} s): server up (index "
                f"{'loaded' if extra else 'built on the card'}) in "
                f"{t_up:.1f} s; {run} driver run {t_drv:.1f} s (host "
                f"clock): {taken.group(0)}; {rec.group(0)}; {mrr.group(0)}")
            for line in out.splitlines():
                if "stage " in line:
                    log(tag, f"  {run} driver " + line.split("] ")[-1])
        if len(blocks) != 1:
            raise AssertionError(f"the two driver runs disagree: {blocks}")
        ok = True
        return rec.group(0), mrr.group(0)
    finally:
        srv.kill()
        srv.wait(timeout=30)
        if not ok:
            with open(log_path, "rb") as f:
                print(f.read()[-3000:].decode(errors="replace"),
                      file=sys.stderr)


def phase_http(engine, disp, data, queries, probes, smi) -> dict:
    """The reference's protocol served over HTTP by the in-process native
    frontend (the JAX bench's serving settings), then the port's server
    and driver as two processes. Returns the numbers of the kernels line."""
    import urllib.request

    from prefhetch_tpu_torch.serve.native_server import serve_forever_native

    t_phase = time.perf_counter()
    # every request of this phase goes to 127.0.0.1: no proxy, whatever
    # the environment names
    os.environ["NO_PROXY"] = os.environ["no_proxy"] = "*"
    cfg = engine.config
    srv = serve_forever_native(engine, port=0, background=True,
                               max_batch=256, grace_ms=1.5, n_resolvers=3)
    addr = f"http://127.0.0.1:{srv.port}/"
    try:
        with urllib.request.urlopen(addr + "stats", timeout=60) as r:
            frontend = json.loads(r.read()).get("frontend", {})
        if frontend.get("name") != "native":
            raise AssertionError(f"/stats reports frontend {frontend}")
        log("http", f"native frontend on :{srv.port} (max_batch 256, grace "
            f"1.5 ms, 3 resolvers); /stats reports it")
        q = queries[:NQ_BATCH]
        sorted_coarse, probes_c, sizes = http_json_protocol(
            cfg, addr, disp, engine, data, q)
        http_binary(cfg, addr, engine, data, q, probes_c, sizes)
        conc = http_concurrency(cfg, srv, disp, queries, probes, smi)
        conc["k2_per_request"] = http_encrypted(cfg, addr, engine, q,
                                                sorted_coarse)
    finally:
        srv.shutdown()
    http_two_processes(cfg, engine.device.type, smi)
    log("http", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return conc


def shard_requests(queries, probes, top_ids, k, cp):
    """The [shard] phase's requests, in order: GET /query and /tiletable,
    then per batch the binary POST /search, the JSON /coarsesearch of every
    candidate, the binary tiled (q16) and top-``cp`` /coarsesearch kinds,
    and the JSON /precisesearch and binary /precise-vector-pir of the
    batch's /search ids, as (route tag, method, path, headers, body)."""
    import numpy as np

    from prefhetch_tpu_torch.utils import wire_bin

    bin_hdr = {"content-type": wire_bin.CONTENT_TYPE}
    reqs = [("/query", "GET", "/query", {}, b""),
            ("/tiletable", "GET", "/tiletable", {}, b"")]
    for b in range(N_BATCHES):
        sl = slice(b * NQ_BATCH, (b + 1) * NQ_BATCH)
        q, p = queries[sl], probes[sl]
        reqs += [
            ("/search", "POST", "/search", bin_hdr, wire_bin.encode(
                wire_bin.KIND_SEARCH_REQ, [q, p, np.array([k], np.uint32)])),
            ("/coarsesearch", "POST", "/coarsesearch", {}, json.dumps(
                {"preciseQuery": q.tolist(),
                 "nearestCentroidIndexes": p.tolist()}).encode()),
            ("/coarsesearch tiled", "POST", "/coarsesearch", bin_hdr,
             wire_bin.encode(wire_bin.KIND_COARSE_REQ, [q, p])),
            ("/coarsesearch top-k", "POST", "/coarsesearch", bin_hdr,
             wire_bin.encode(wire_bin.KIND_COARSE_TOPK_REQ,
                             [q, p, np.array([cp], np.uint32)])),
            ("/precisesearch", "POST", "/precisesearch", {}, json.dumps(
                {"preciseQuery": q.tolist(),
                 "nearestCoarseVectorIndexes":
                     top_ids[sl].tolist()}).encode()),
            ("/precise-vector-pir", "POST", "/precise-vector-pir", bin_hdr,
             wire_bin.encode(wire_bin.KIND_FETCH_REQ,
                             [top_ids[sl].astype(np.int64)])),
        ]
    return reqs


def run_requests(disp, reqs, reset_counts) -> tuple:
    """Each request through the Dispatcher with the kernel counts set to 0
    just before the /search requests and read just after them → (bodies,
    host-clock ms by route, K1 launches over the /search requests)."""
    from prefhetch_tpu_torch.ops import ntt4_step as k2s
    from prefhetch_tpu_torch.ops import union_scan_min as usm

    bodies, ms, k1 = [], {}, 0
    for tag, method, path, hdr, body in reqs:
        if tag == "/search":
            reset_counts()
        t0 = time.perf_counter()
        status, _, out = disp.handle(method, path, hdr, body)
        ms.setdefault(tag, []).append((time.perf_counter() - t0) * 1e3)
        if tag == "/search":
            k1 += usm.union_scan_min.launches
            if usm.union_scan_min_reference.calls or k2s.ntt4_step_plain.calls:
                raise AssertionError("a plain version ran on /search")
        if status != 200:
            raise AssertionError(f"{method} {path}: {status} {out[:300]!r}")
        bodies.append(out)
    return bodies, ms, k1


def phase_shard(engine, disp, data, queries, probes, top_ids, cands,
                reset_counts, smi) -> dict:
    """Sharding on the engine, index and base of the main phase, run last
    (it leaves the engine sharded): the unsharded engine's answers to
    GET /query and /tiletable and N_BATCHES x (POST /search, JSON, tiled
    and top-k /coarsesearch, JSON /precisesearch, binary
    /precise-vector-pir); then enable_sharding() over every visible card (a
    mesh of one) and over 4 shards of cuda:0, each answering the same
    requests byte for byte, K1 launched once a shard a /search batch and
    held against its plain version at every shard's union share of the
    first batch, the card memory the shards add; the q1 MAC query-sharded
    (64 queries x 256 candidates, meshes of 1 and 4) bit-equal to the one-
    device program, decrypted exactly, K2 held against its plain version at
    every shape it launched; the PIR answer with its database sharded at
    the SIFT1M grid (meshes of 1 and 3, the smallest that divides g1 =
    177) bit-equal to answer_2d and its row exact, a mesh of 4 refused; an NCCL world of one; the dry run on 4
    shards of the card. Returns the numbers of the kernels line."""
    import socket

    import numpy as np
    import torch

    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.crypto.pir import PIRClient
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import union_scan_min as usm
    from prefhetch_tpu_torch.ops.rerank import exact_rerank
    from prefhetch_tpu_torch.ops.union_scan import (
        union_probe_tiles, union_scan_pruned_fused,
    )
    from prefhetch_tpu_torch.parallel.dryrun import dryrun_multichip
    from prefhetch_tpu_torch.parallel.mesh import make_mesh
    from prefhetch_tpu_torch.parallel.multihost import (
        init_multihost, shard_array_global, shard_index_multihost,
        shutdown_multihost,
    )
    from prefhetch_tpu_torch.parallel.sharded import (
        partition_union, shard_index, shard_rows, shard_tiled_view,
        sharded_rerank, sharded_trunc_mac_q1, sharded_union_scan_pruned,
    )

    t_phase = time.perf_counter()
    dev = engine.device
    cfg = engine.config
    k = cfg.protocol.k
    out = {"k1": {}, "k2": {}}

    # -- the plaintext routes: unsharded, then meshes of 1 and 4 ------------
    reqs = shard_requests(queries, probes, top_ids, k,
                          cfg.protocol.coarse_probe)
    want, ms0, _ = run_requests(disp, reqs, reset_counts)
    log("shard", f"{smi}: unsharded engine, {len(reqs)} requests (host "
        f"clock, ms): " + "; ".join(
            f"{t} {', '.join(f'{x:.1f}' for x in v)}"
            for t, v in ms0.items()))
    q0 = queries[:NQ_BATCH]
    # what the fixed-shape products cost: union_distances (the f32 union
    # scan of the JSON, tiled and top-k routes) on the first batch, at
    # SCAN_CHUNK tiles a product and at one product over the whole union
    view = engine._tiled_view
    _, qd, union1, _, _ = engine._tiled_batch_prep(probes[:NQ_BATCH], q0)
    args = (view.payload, view.norms, view.sizes, qd, union1)
    chunk = usm.SCAN_CHUNK
    t_chunk = cuda_time_ms(lambda: usm.union_distances(*args), iters=10)
    usm.SCAN_CHUNK = union1.shape[0]
    try:
        t_one = cuda_time_ms(lambda: usm.union_distances(*args), iters=10)
    finally:
        usm.SCAN_CHUNK = chunk
    log("shard", f"{smi}: union_distances at U={union1.shape[0]}, nq="
        f"{NQ_BATCH}: {t_chunk:.4f} ms at {chunk} tiles a product, "
        f"{t_one:.4f} ms as one product over the union (CUDA events)")
    out["union_distances_ms"] = {"chunked": t_chunk, "one_product": t_one}
    for name, kw in (("all visible cards", {}),
                     ("4 shards of cuda:0", {"devices": [dev] * 4})):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        engine.enable_sharding(**kw)
        st = engine._sharded_tiled
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        mesh = engine._mesh
        n = mesh.ndev
        views = sum(
            int(sh.data_ptr() == engine._tiled_view.payload[
                gid * st.tpl].data_ptr())
            for (gid, _), sh in zip(mesh.local_shards(), st.payload)
            if gid * st.tpl < engine._tiled_view.payload.shape[0])
        log("shard", f"mesh of {n} ({name}): card memory allocated "
            f"{mem0 / 1e9:.3f} -> {mem1 / 1e9:.3f} GB after sharding the "
            f"index, base and tiled view (+{(mem1 - mem0) / 1e6:.3f} MB; "
            f"{views}/{len(st.payload)} payload shards are views of the "
            f"unsharded payload, {st.tpl} tiles a shard)")
        # K1 against its plain version at every shard's union share of the
        # first batch
        tile_idx, qd, union_dev, pos_dev, _ = engine._tiled_batch_prep(
            probes[:NQ_BATCH], q0)
        u_loc = union_dev.shape[1]
        locs = []
        for i, (gid, sdev) in enumerate(mesh.local_shards()):
            loc = torch.from_numpy(union_dev[gid]).long()
            locs.append((loc - gid * st.tpl).clamp(0, st.tpl - 1).to(
                torch.int32).to(sdev))
            check_union_scan_min(
                f"shard{n}/s{gid}/batch0", st.payload[i], st.norms[i],
                st.sizes[i], qd, locs[-1], min_atol=4.0)
        got, ms, k1 = run_requests(disp, reqs, reset_counts)
        for (tag, *_), a, b in zip(reqs, want, got):
            if a != b:
                raise AssertionError(f"mesh of {n}: {tag} differs from the "
                                     f"unsharded engine's response")
        if k1 != N_BATCHES * n:
            raise AssertionError(f"mesh of {n}: K1 launched {k1} times for "
                                 f"{N_BATCHES} batches")
        out["k1"][f"mesh{n}"] = k1
        log("shard", f"{smi}: mesh of {n}: all {len(reqs)} responses "
            f"byte-identical to the unsharded engine's; K1 launches over "
            f"the {N_BATCHES} /search requests {k1} (= {N_BATCHES} x {n}), "
            f"union share u_loc {u_loc} tiles a shard; host clock, ms: "
            + "; ".join(
                f"{t} {', '.join(f'{x:.1f}' for x in v)}"
                for t, v in ms.items()))
        if n == 4:
            # K1's time at one shard's share (the first), beside its bound
            loc = locs[0]
            args = (st.payload[0], st.norms[0], st.sizes[0], qd, loc)
            ev = cuda_time_ms(lambda: usm.union_scan_min(*args))
            shard_ms = kernel_ms(lambda: usm.union_scan_min(*args),
                                 "union_scan_min_bf16_kernel", ev)
            plain_ms = cuda_time_ms(
                lambda: usm.union_scan_min_reference(*args), iters=5)
            bnd, by, nbytes, _, _ = k1_bound(st.payload[0], st.sizes[0],
                                             loc, NQ_BATCH)
            out["k1_shard"] = {"mesh": n, "u_loc": u_loc, "ms": shard_ms,
                               "ms_events": ev, "plain_ms": plain_ms,
                               "bound_ms": bnd, "bound_by": by}
            log("shard", f"{smi}: K1 on shard 0's share (U={u_loc}, nq="
                f"{NQ_BATCH}): {shard_ms:.4f} ms device time (profiler; "
                f"CUDA events over wrapper calls {ev:.4f}), plain "
                f"{plain_ms:.4f} ms (CUDA events), bound {bnd:.4f} ms "
                f"({by}, {nbytes / 1e6:.1f} MB)")

    # -- the q1 MAC, query-sharded ------------------------------------------
    svc = engine.he_service
    he_q1 = dataclasses.replace(cfg.he, resp_mod="q1", sparse_h=Q1_SPARSE_H)
    client = HEClient(he_q1, seed=12)
    sl = slice((N_BATCHES - 1) * NQ_BATCH, N_BATCHES * NQ_BATCH)
    qs, cand = queries[sl], cands[-1]
    ctq, idx, norms = svc.prepare(
        [svc.ctx.ct_from_wire(w) for w in client.encrypt_query_batch(qs)],
        cand)
    ctq_d, idx_d = svc.upload(ctq, idx)
    one = svc._trunc_mac_q1(ctq_d, idx_d)
    one_ms = cuda_time_ms(lambda: svc._trunc_mac_q1(ctq_d, idx_d),
                          iters=5, warmup=1)
    recorded = {}
    for n in (1, 4):
        mesh = make_mesh(devices=[dev] * n)
        base_sh = shard_rows(svc._base_dev, mesh, pad=True)
        reset_counts()
        with recording_k2() as rec:
            got = sharded_trunc_mac_q1(mesh, base_sh, ctq_d, idx_d,
                                       svc.params)
            torch.cuda.synchronize()
        launches = k2.ntt4_transform.launches
        if launches != 6 * n or len(rec) != launches:
            raise AssertionError(f"q1 MAC over {n} shards: {launches} K2 "
                                 f"launches, not {6 * n}")
        if not torch.equal(got, one):
            raise AssertionError(f"q1 MAC over {n} shards differs from the "
                                 f"one-device program")
        t_ms = cuda_time_ms(lambda: sharded_trunc_mac_q1(
            mesh, base_sh, ctq_d, idx_d, svc.params), iters=5, warmup=1)
        recorded[f"the q1 MAC over {n} shards"] = rec
        out["k2"][f"q1_mac_mesh{n}"] = launches
        log("shard", f"{smi}: q1 MAC, {NQ_BATCH} queries x "
            f"{cand.shape[1]} candidates over {n} shard(s) of the card: "
            f"bit-equal to the one-device program, {launches} K2 launches; "
            f"{t_ms:.3f} ms (CUDA events) against {one_ms:.3f} on one "
            f"device")
        if n == 4:
            c1w, c0w, nrm = svc.trunc_unbundle_q1(got.cpu().numpy(), norms)
            dists = client.decrypt_scores_trunc_q1(c1w, c0w, nrm, qs)
            if not np.array_equal(dists, engine.precise_search(qs, cand)):
                raise AssertionError("the sharded q1 MAC does not decrypt "
                                     "to precise_search")
        del base_sh
    del ctq_d, idx_d, one

    # -- the PIR answer with its database sharded ---------------------------
    pir = engine.pir2_service
    nbase, d = data["base"].shape
    pcl = PIRClient(pir.params, seed=13)
    pir.register_galois_keys(pcl.key_id, pcl.galois_keys_wire_2d(nbase, d))
    row = int(top_ids[0, 0])
    w, r = pcl.build_query_2d(row, nbase, d)
    pir.answer_2d(w, pcl.key_id)          # the new keys' first program
    t0 = time.perf_counter()
    want_pir = pir.answer_2d(w, pcl.key_id)
    one_ms = (time.perf_counter() - t0) * 1e3
    # the smallest mesh above 1 that divides g1 (3 at SIFT1M: g1 = 177 =
    # 3·59) and one that does not (4)
    div = next((n for n in range(2, pir.g1 + 1) if pir.g1 % n == 0))
    bad = next(n for n in range(4, pir.g1 + 2) if pir.g1 % n)
    for n in (1, div):
        reset_counts()
        with recording_k2() as rec:
            t0 = time.perf_counter()
            got_pir = pir.answer_2d_sharded(w, pcl.key_id,
                                            make_mesh(devices=[dev] * n))
            t_ms = (time.perf_counter() - t0) * 1e3
        launches = k2.ntt4_transform.launches
        if got_pir != want_pir:
            raise AssertionError(f"PIR answer over {n} shards differs from "
                                 f"answer_2d")
        if not np.array_equal(pcl.decode_response_2d(got_pir, d, r),
                              data["base"][row].astype(np.int64)):
            raise AssertionError("the sharded PIR answer does not decode "
                                 "to its row")
        recorded[f"the PIR answer over {n} shards"] = rec
        out["k2"][f"pir_mesh{n}"] = launches
        log("shard", f"{smi}: PIR answer, grid {pir.g1} x {pir.g2}, "
            f"database over {n} shard(s) ({pir.g1 // n} rows each): "
            f"bit-equal to answer_2d, row {row} exact, {launches} K2 "
            f"launches; {t_ms:.1f} ms (host clock) against {one_ms:.1f} "
            f"for a warm answer_2d")
    try:
        pir.answer_2d_sharded(w, pcl.key_id, make_mesh(devices=[dev] * bad))
        raise AssertionError(f"a mesh of {bad} was not refused")
    except ValueError as e:
        if f"not divisible by {bad} devices" not in str(e):
            raise
        log("shard", f"mesh of {bad} refused: {e}")
    out["k2_err"] = check_k2_path("shard", recorded, dev)

    # -- an NCCL world of one -------------------------------------------------
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    wmesh = init_multihost(f"127.0.0.1:{port}", 1, 0,
                           local_device_ids=[dev.index])
    try:
        import torch.distributed as dist

        a = shard_index_multihost(engine.index, wmesh)
        b = shard_index(engine.index, make_mesh(devices=[dev]))
        for f in ("centroids", "list_ids", "list_sizes", "list_recon"):
            if not torch.equal(getattr(a.shards[0], f),
                               getattr(b.shards[0], f)):
                raise AssertionError(f"shard_index_multihost {f} differs")
        view = engine._tiled_view
        st = shard_tiled_view(view, wmesh)
        tiles, _ = view.expand_probes(
            probes[:NQ_BATCH], min_t=engine._serve_mt[probes.shape[1]])
        u_np, p_np = union_probe_tiles(tiles, view.empty_tile)
        ud, pd, _ = partition_union(u_np, p_np, view.empty_tile, st.tpl, 1)
        q0d = torch.from_numpy(q0).to(dev)
        j = engine._serve_prune_j(tiles.shape[1])
        got = sharded_union_scan_pruned(wmesh, st, q0d, ud, pd, j)
        ref = union_scan_pruned_fused(
            view.payload, view.norms, view.sizes, q0d,
            torch.from_numpy(u_np.astype(np.int32)).to(dev),
            torch.from_numpy(p_np).to(dev), j)
        for x, y in zip(got, ref):
            if not torch.equal(x, y):
                raise AssertionError("the pruned scan through the world "
                                     "differs from one device")
        cand_t = torch.from_numpy(top_ids[:NQ_BATCH]).to(dev)
        sc = sharded_rerank(wmesh, shard_array_global(data["base"], wmesh),
                            q0d, cand_t)
        if not torch.equal(sc, exact_rerank(engine.base, q0d, cand_t)):
            raise AssertionError("the re-rank through the world differs")
        log("shard", f"init_multihost: a world of 1 over "
            f"{dist.get_backend()} (NCCL refuses two ranks on one card); "
            f"shard_index_multihost = shard_index; the pruned scan (K1) "
            f"and the re-rank through the world's collectives bit-equal "
            f"to one device")
    finally:
        shutdown_multihost()

    # -- the dry run on 4 shards of the card -----------------------------------
    t0 = time.perf_counter()
    dr = dryrun_multichip(4, device=dev)
    log("shard", f"{smi}: dryrun_multichip(4) on {dev}: {json.dumps(dr)} "
        f"in {time.perf_counter() - t0:.1f} s (host clock)")
    log("shard", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


# the bench's keys a section must print (bench.py's names; PERF.md § 4)
BENCH_KEYS = {
    "core": ("recall_at_10", "recall_at_100", "numpy_recall_at_100",
             "numpy_recall_gap_at_100", "scan_bytes_per_query",
             "batch_p50_ms", "batch_p99_ms", "stage_ms",
             "numpy_baseline_qps"),
    "encrypted": ("encrypted_rerank_qps", "encrypted_mac_device_qps",
                  "encrypted_mac_kernel_qps",
                  "encrypted_wire_bytes_per_query", "http_encrypted_qps",
                  "http_encrypted_p50_ms", "http_encrypted_max_err"),
    "http": ("http_qps", "http_p50_ms", "http_p99_ms",
             "http_multiround_qps", "http_multiround_p99_ms",
             "http_allcand_qps", "http_frontend", "http_server_phases",
             "http_mean_wave"),
    "ckks": ("ckks_scoring_qps", "ckks_max_rel_err", "ckks_device_qps",
             "ckks_wire_kb_per_query"),
    "pq": ("pq_onehot_qps", "pq_recall_at_10", "pq_recall_at_100",
           "pq_numpy_recall_gap_at_100", "pq_scan_bytes_per_query"),
    "pir": ("pir_nbase", "pir_multi100_ms_per_row", "pir_rows_per_ct",
            "pir_multi_upload_bytes_per_row"),
    "angular": ("angular_qps", "angular_recall_at_10",
                "angular_recall_at_100", "angular_numpy_recall_gap_at_100"),
    "hard": ("hard_recall_at_10", "hard_recall_at_100",
             "hard_oracle_recall_at_10", "hard_oracle_recall_at_100",
             "hard_numpy_recall_gap_at_100", "hard_frontier",
             "hard_best_recall_at_100"),
}
# the kernel each section must launch: K1, K2 or K3
BENCH_KERNELS = {"core": "union_scan_min", "angular": "union_scan_min",
                 "hard": "union_scan_min", "pq": "pq_probed_distances",
                 "encrypted": "ntt4_transform", "ckks": "ntt4_transform",
                 "pir": "ntt4_transform"}
# two runs, side by side: at the full SIFT1M point the sections no earlier
# phase drives (the headline with its numpy baseline, angular, hard); at
# 100K the others
BENCH_RUNS = {
    "sift1m": ({}, ("core", "angular", "hard")),
    "100k": ({"PFH_BENCH_NBASE": "100000"},
             ("core", "encrypted", "http", "ckks", "pq", "pir")),
}


def check_k1_at_bench(name: str, args) -> dict:
    """K1 against its plain version on the inputs a bench launch had. The
    tolerances are the SIFT-scale ones of check_union_scan_min (0.5 and
    4.0 at a largest term of ~6e6) as shares of the inputs' largest term
    (|q|^2 + the largest norm): 2^-23 of it for d2, 2^-20 for the tile
    minimum, so unit vectors (angular) are held as tightly."""
    payload, norms, sizes, q, union = args
    scale = float((q.float() ** 2).sum(-1).max() + norms.max())
    err = check_union_scan_min(name, payload, norms, sizes, q, union,
                               min_atol=scale * 2.0 ** -20,
                               d2_atol=scale * 2.0 ** -23)
    return {"shape": {"U": union.shape[0], "nq": q.shape[0],
                      "T": payload.shape[1], "d": payload.shape[2],
                      "dtype": str(payload.dtype)[6:]},
            "max_abs_err": err, "d2_atol": scale * 2.0 ** -23}


def bench_child(argv) -> int:
    """``python chip_smoke.py --bench-child [bench arguments]``: the bench's
    main in this process, with each section's first K1 launch and its
    widest (most queries), its first K3 launch, and every K2 launch's shape
    (the first one's input and output kept) recorded through the names the
    bench's path calls (ops/union_scan's, ops/ntt4's), so no wrapper's
    count moves. After each section (its launches already printed) each
    recorded K1 and K3 launch is held against its plain version on its
    inputs, the first K2 launch's output against the plain version of its
    input, and K2 at every other recorded shape on fresh residues; a line
    ``[bench-check] {json}`` a kernel and section goes to stderr. Exits 3
    when a check failed, else with the bench's code."""
    global LOG_TO
    import torch

    from prefhetch_tpu_torch.bench import __main__ as bm
    from prefhetch_tpu_torch.ops import ntt4 as n4
    from prefhetch_tpu_torch.ops import union_scan as us

    LOG_TO = sys.stderr
    rec: dict = {"section": None}
    k1s: dict = {}                # section -> {"first": args, "widest": args}
    k3s: dict = {}                # section -> args
    k2s: dict = {}                # section -> {"shapes": {...}, "first": ...}
    real_k1, real_k3 = us.union_scan_min, us.pq_probed_distances
    real_k2 = n4.ntt4_transform

    def k1(*args):
        if rec["section"] is None:            # a check's own launch
            return real_k1(*args)
        got = k1s.setdefault(rec["section"], {"first": args, "widest": args})
        if args[3].shape[0] > got["widest"][3].shape[0]:
            got["widest"] = args
        return real_k1(*args)

    def k3(*args):
        if rec["section"] is None:
            return real_k3(*args)
        k3s.setdefault(rec["section"], args)
        return real_k3(*args)

    def k2(x, tb, inverse):
        out = real_k2(x, tb, inverse)
        if rec["section"] is None:
            return out
        got = k2s.get(rec["section"])
        if got is None:
            got = k2s[rec["section"]] = {"shapes": {}, "first": (
                x.clone(), tb, bool(inverse), out.clone())}
        got["shapes"].setdefault(
            (x.shape[0], x.dtype, bool(inverse), tb.q), tb)
        return out

    def check(name: str) -> list:
        entries = []
        got = k1s.pop(name, None)
        for which in ("first", "widest") if got else ():
            if which == "widest" and got["widest"] is got["first"]:
                continue
            entries.append({"kernel": "union_scan_min", "launch": which,
                            **check_k1_at_bench(f"bench/{name}/{which}",
                                                got[which])})
        if name in k3s:
            args = k3s.pop(name)
            err = check_pq_probed(f"bench/{name}", *args)
            entries.append({"kernel": "pq_probed_distances",
                            "launch": "first", "shape": {
                                "nq": args[6].shape[0],
                                "max_t": args[6].shape[1],
                                "T": args[0].shape[1],
                                "M": args[0].shape[2]},
                            "max_abs_err": err})
        if name in k2s:
            got = k2s.pop(name)
            x, tb, inverse, out = got.pop("first")
            dev = x.device
            err = check_transform(f"bench/{name}/first", x, tb, inverse,
                                  got=out)
            del x, out
            gen = torch.Generator(device=dev).manual_seed(17)
            for (rows, dtype, inv, q), tbi in sorted(
                    got["shapes"].items(), key=lambda kv: kv[0][0]):
                xr = torch.randint(0, q, (rows, tbi.n), generator=gen,
                                   device=dev, dtype=dtype)
                err = max(err, check_transform(
                    f"bench/{name}/[{rows}] {str(dtype)[6:]} "
                    f"{'inverse' if inv else 'forward'} mod {q}", xr, tbi,
                    inv))
                del xr
            entries.append({"kernel": "ntt4_transform",
                            "launch": "first, and every shape",
                            "shapes": len(got["shapes"]),
                            "widest_rows": max(r for r, *_ in
                                               got["shapes"]),
                            "max_abs_err": err})
        return entries

    failures = []
    real_section = bm.Bench.section

    def section(self, name, fn, est_s=None):
        rec["section"] = name
        try:
            real_section(self, name, fn, est_s)
        finally:
            rec["section"] = None
        try:
            for entry in check(name):
                print("[bench-check] " + json.dumps({"section": name,
                                                     **entry}),
                      file=sys.stderr, flush=True)
        except Exception as e:            # noqa: BLE001 — reported
            failures.append(name)
            print("[bench-check] " + json.dumps({
                "section": name, "error": f"{type(e).__name__}: {e}"[:400]}),
                file=sys.stderr, flush=True)
        finally:
            k1s.pop(name, None), k3s.pop(name, None), k2s.pop(name, None)
            torch.cuda.empty_cache()

    us.union_scan_min, us.pq_probed_distances = k1, k3
    n4.ntt4_transform = k2
    bm.Bench.section = section
    try:
        code = bm.main(argv)
    finally:
        us.union_scan_min, us.pq_probed_distances = real_k1, real_k3
        n4.ntt4_transform = real_k2
        bm.Bench.section = real_section
    return 3 if failures else code


def phase_bench(smi: str) -> dict:
    """python -m prefhetch_tpu_torch.bench's main in two processes at once
    (each a bench child of this script; the caches under
    prefhetch_tpu_torch/build/bench_cache/, kept between runs): exit 0, one
    line with every section's keys, no error, only the sections left out
    skipped; each section's kernel launched by its wrapper, no plain
    version run, and each kernel held against its plain version at the
    section's own shapes (bench_child). The two runs share the card, so
    their figures are not measurements (PERF.md takes the bench's figures
    from a run of its own). Returns {"launches": each kernel's launches
    summed over the runs' sections, "at_shape": {kernel: {run/section:
    check}}}."""
    from prefhetch_tpu_torch.bench.data import SECTIONS
    from prefhetch_tpu_torch.bench.encrypted import (
        CKKS_MAX_REL as BENCH_CKKS_MAX_REL,
    )

    t_phase = time.perf_counter()
    procs = {}
    for tag, (env_add, run) in BENCH_RUNS.items():
        cache = os.path.join(ROOT, "prefhetch_tpu_torch", "build",
                             "bench_cache", tag)
        env = {**os.environ, **env_add,
               **{var: "1" for name, var in SECTIONS if name not in run}}
        procs[tag] = (subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--bench-child", "--cache", cache],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=ROOT), run)
    totals: dict = {}
    at_shape: dict = {}
    try:
        for tag, (proc, run) in procs.items():
            out, err = proc.communicate(timeout=900)
            err = err.decode(errors="replace")
            launches, checks = {}, []
            for ln in err.splitlines():
                if ln.startswith("[bench] launches "):
                    name, _, js = ln[len("[bench] launches "):].partition(" ")
                    launches[name] = json.loads(js)
                elif ln.startswith("[bench] section "):
                    log("bench", f"{tag}: {ln[len('[bench] '):]}")
                elif ln.startswith("[bench-check] "):
                    checks.append(json.loads(ln[len("[bench-check] "):]))
            if proc.returncode != 0:
                print(err[-6000:], file=sys.stderr)
                raise AssertionError(f"bench {tag} exited {proc.returncode}")
            line = json.loads(out.decode().strip().splitlines()[-1])
            extra = line["extra"]
            skipped = [n for n, _ in SECTIONS if n not in run]
            if extra.get("failed") or extra.get("skipped") != skipped:
                raise AssertionError(f"bench {tag}: failed "
                                     f"{extra.get('failed')}, skipped "
                                     f"{extra.get('skipped')}")
            errors = [k for k in extra if k.endswith("_error")]
            missing = [k for name in run for k in BENCH_KEYS[name]
                       if k not in extra]
            if errors or missing or line["value"] <= 0:
                raise AssertionError(f"bench {tag}: errors {errors}, "
                                     f"missing keys {missing}")
            for name in run:
                got = launches[name]
                kernel = BENCH_KERNELS.get(name)
                if kernel and got["launches"][kernel] <= 0:
                    raise AssertionError(f"bench {tag}: {kernel} never "
                                         f"launched in {name}")
                if got["plain_calls"]:
                    raise AssertionError(f"bench {tag}: a plain version "
                                         f"ran in {name}")
                if kernel and not any(c["section"] == name
                                      and c.get("kernel") == kernel
                                      for c in checks):
                    raise AssertionError(f"bench {tag}: {kernel} not held "
                                         f"to its plain version in {name}")
                for k, v in got["launches"].items():
                    totals[k] = totals.get(k, 0) + v
                log("bench", f"{tag} {name}: launches "
                    f"{ {k: v for k, v in got['launches'].items() if v} }")
            for c in checks:
                log("bench", f"{tag}: held to the plain version: "
                    f"{json.dumps(c)}")
                at_shape.setdefault(c["kernel"], {})[
                    f"{tag}/{c['section']}/{c['launch']}"] = {
                    k: v for k, v in c.items()
                    if k not in ("kernel", "section", "launch")}
            if "hard" in run:
                for at in ("10", "100"):
                    if (extra[f"hard_recall_at_{at}"]
                            > extra[f"hard_oracle_recall_at_{at}"]):
                        raise AssertionError("hard recall above its oracle")
            if tag == "sift1m" and (extra["recall_at_10"] < RECALL10_MIN
                                    or extra["recall_at_100"]
                                    < RECALL100_MIN):
                raise AssertionError(f"bench core recall {extra}")
            if "encrypted" in run and extra["http_encrypted_max_err"] != 0:
                raise AssertionError("encrypted distances over HTTP inexact")
            if "ckks" in run and not (extra["ckks_max_rel_err"]
                                      <= BENCH_CKKS_MAX_REL):
                raise AssertionError("ckks_max_rel_err above its limit")
            figures = {k: extra[k] for name in run for k in BENCH_KEYS[name]
                       if not isinstance(extra[k], (dict, list))}
            log("bench", f"{tag} ({smi}; two runs sharing the card: not "
                f"measurements): value {line['value']:.1f} q/s, "
                f"vs_baseline {line['vs_baseline']:.2f}, "
                f"{json.dumps(figures)}")
            log("bench", f"{tag}: section seconds "
                f"{json.dumps(extra['section_s'])}, wall "
                f"{extra['bench_wall_s']:.1f} s")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    log("bench", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": totals, "at_shape": at_shape}


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

    from concurrent.futures import ThreadPoolExecutor

    from prefhetch_tpu_torch import native
    from prefhetch_tpu_torch.data.io import write_fvecs
    from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
    from prefhetch_tpu_torch.engine.server import QueryEngine
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s
    from prefhetch_tpu_torch.ops import union_scan_min as usm
    from prefhetch_tpu_torch.ops.distances import rank_centroids
    from prefhetch_tpu_torch.ops.topk import topk_smallest
    from prefhetch_tpu_torch.serve.handlers import Dispatcher
    from prefhetch_tpu_torch.utils import cuda_build, wire_bin
    from prefhetch_tpu_torch.utils.config import SIFT1M_PRESET

    t_start = time.perf_counter()

    # -- 1. card ----------------------------------------------------------
    def nvidia_smi(fields: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]

    smi = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log("card", f"nvidia-smi: {smi}")
    log("card", f"torch: {kind}, devices: {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda:0")

    # -- 2. build -----------------------------------------------------------
    kernels = ["union_scan_min", "ntt4_step", "pq_onehot", "slab_scan",
               "tile_schedule", "pir_fold1", "key_switch"]
    for name in kernels:                  # always compile from the sources
        cuda_build.library_path(name).unlink(missing_ok=True)
    # the host C++ libraries (host NTT and vecs reader, JSON codec, epoll
    # frontend), built beside nvcc
    host_names = (native.HOST, native.CODEC, native.HTTP)
    for name in host_names:
        native.library_path(name).unlink(missing_ok=True)
    with ThreadPoolExecutor(len(host_names)) as pool:
        t0 = time.perf_counter()
        host_libs = [pool.submit(native.build, n) for n in host_names]
        built = cuda_build.build(kernels)
        for f in host_libs:
            f.result()
        log("build", f"host libraries {', '.join(host_names)} (g++): "
            f"{time.perf_counter() - t0:.2f} s with nvcc beside them")
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{name}: {info['seconds']:.2f} s; "
            + " | ".join(ptxas))
    check_tensor_core_sass(built["union_scan_min"]["path"], ("HMMA", "HGMMA"),
                           "K1")
    check_tensor_core_sass(built["ntt4_step"]["path"], ("IMMA",), "K2")

    # -- 3. kernels at edge shapes -----------------------------------------
    phase_edges()
    phase_variant_edges()
    phase_ntt()
    phase_native(smi)

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
    def reset_counts() -> None:
        wrappers, plains = kernel_counters()
        for w in wrappers.values():
            w.launches = 0
        for p in plains:
            p.calls = 0

    reset_counts()
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
    launches = {"union_scan_min": usm.union_scan_min.launches,
                "ntt4_transform": k2.ntt4_transform.launches}
    plain_calls = (usm.union_scan_min_reference.calls
                   + k2s.ntt4_step_plain.calls)
    log("main", f"POST /search x{N_BATCHES} of {NQ_BATCH} queries: "
        f"{', '.join(f'{t:.1f}' for t in req_ms)} ms (host clock, first "
        f"request includes warm-up); launches {launches}, plain-version "
        f"calls {plain_calls}")
    if launches["union_scan_min"] < N_BATCHES:
        raise AssertionError("K1 did not run on every /search request")
    if plain_calls != 0:
        raise AssertionError("the plain version ran on the main path")

    base64 = torch.from_numpy(data["base"]).to(dev, torch.float64)
    q64 = torch.from_numpy(queries).to(dev, torch.float64)
    rep, _ = check_answers("/search", np.concatenate(ids_all),
                           np.concatenate(dists_all), base64, q64,
                           data["groundtruth"], k)
    log("main", f"recall@1 {rep.recall_1} recall@10 {rep.recall_10} "
        f"recall@100 {rep.recall_100} mrr@10 {rep.mrr_10}")

    # -- 4b. the encrypted re-rank at the same operating point ---------------
    enc_launches, k2_per_request, k2_err, cands, rep_e = phase_encrypted(
        engine, disp, data, queries, probes, reset_counts)
    scores_launches, scores_per_call, k2_err_s = phase_scores(
        engine, data, queries, cands, reset_counts, smi)
    k2_per_request.update(scores_per_call)
    k2_err = max(k2_err, k2_err_s)
    packed_launches, k2_per_request["packed"], k2_err_p = phase_packed(
        engine, disp, data, queries, cands, rep_e, reset_counts, smi)
    ckks_launches, ckks_per_request, k2_err_c = phase_ckks(
        engine, disp, data, queries, cands, reset_counts, smi)
    k2_per_request.update(ckks_per_request)
    pir_launches, pir_per_request, k2_err_pir, k2_pir, pir_path = phase_pir(
        engine, disp, data["base"], ids_all[0][:1], reset_counts, smi)
    k2_per_request.update(pir_per_request)
    k2_err = max(k2_err, k2_err_p, k2_err_c, k2_err_pir)

    # -- 4c. the reference's protocol served over HTTP ------------------------
    http = phase_http(engine, disp, data, queries, probes, smi)

    # -- 4d. the quantised and slab scan variants of the triage pipeline -----
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    hold = {}
    variant_rows = phase_variants(engine, data, queries, reset_counts, sm_mhz,
                                  rep, base64, q64, hold)

    # -- 4e. the dense-layout path: entry(), the models, the dense branch ----
    phase_entry(engine, data, queries, reset_counts, smi, rep, base64, q64)
    del base64, q64

    # -- 5. timings at the main-path shape (first batch) ---------------------
    args = (view.payload, view.norms, view.sizes, q1, union1)
    ms = cuda_time_ms(lambda: usm.union_scan_min(*args))
    plain_ms = cuda_time_ms(lambda: usm.union_scan_min_reference(*args))
    ms2 = cuda_time_ms(lambda: usm.union_scan_min(*args))
    dev_ms = kernel_ms(lambda: usm.union_scan_min(*args),
                       "union_scan_min_bf16_kernel", min(ms, ms2))
    # library yardstick: one torch.matmul of the bf16 cross term alone
    # [nq, d] x [d, U_real*T] — a part of K1's function, not all of it
    sizes_u = view.sizes[union1.long()]
    real = union1[sizes_u > 0].long()
    slab_t = view.payload[real].reshape(-1, D).T.contiguous()
    qc = q1.to(view.payload.dtype)
    library_ms = cuda_time_ms(lambda: torch.matmul(qc, slab_t))
    library_dev = device_ms(lambda: torch.matmul(qc, slab_t))
    del slab_t
    nq1 = q1.shape[0]
    bound_ms, bound_by, bytes_moved, flops, rows = k1_bound(
        view.payload, view.sizes, union1, nq1)
    log("timing", f"union_scan_min at U={U1} (real tiles {len(real)}, "
        f"valid rows {rows}) nq={nq1} T={view.tile} d={D}: kernel "
        f"{dev_ms:.4f} ms on the device ({bytes_moved / dev_ms / 1e6:.0f} GB/s of the "
        f"bound's bytes; CUDA events over wrapper calls {ms:.4f} / "
        f"{ms2:.4f}), plain {plain_ms:.4f} ms, torch.matmul cross term "
        f"{library_ms:.4f} ms (device {library_dev}), bound "
        f"{bound_ms:.4f} ms ({bound_by}: "
        f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    k1_headline = time_k1_headline(engine.index, queries,
                                   cfg.protocol.nprobe, smi)
    svc = engine.he_service
    nbatch = NQ_BATCH * -(-cfg.protocol.coarse_probe // (svc.params.n // D))
    k2_times = time_ntt4_transform(svc._tables[0], nbatch)
    # the packed key switch: L digit rows a block row, on the special
    # prime, its digits and sums int32 (ops/key_switch.py)
    k2_packed = time_ntt4_transform(svc._ext_tables[-1],
                                    nbatch * len(svc.params.qs),
                                    inverse_int64=False)
    # the CKKS key switch's largest transform: [2048, 8192] on the special
    # prime (512 block rows x 4 digit components, pre-combine)
    k2_ckks = time_ntt4_transform(engine.ckks_service._tables[-1], 2048,
                                  inverse_int64=False)
    # one query's whole-ciphertext scores: its 8 blocks a limb
    k2_scores1 = time_ntt4_transform(svc._tables[0], nbatch // NQ_BATCH)
    profile_search(disp, queries, probes, k)
    phase_ablation(hold.pop("sq8"), hold.pop("slab"), svc._tables[0], nbatch)

    # -- 6. sharding, last: it leaves the engine sharded ----------------------
    shard = phase_shard(engine, disp, data, queries, probes,
                        np.concatenate(ids_all), cands, reset_counts, smi)
    k2_err = max(k2_err, shard["k2_err"])
    for name, was in BUTTERFLY_FIGURES.items():
        log("native", f"{smi}: re-timed on the native host NTT (host "
            f"clock): {name} {HOST_STAGES.get(name, 'not measured')}; on "
            f"the butterfly {was}")

    # -- 7. the benchmark entry point, python -m prefhetch_tpu_torch.bench --
    bench = phase_bench(smi)
    bench_launches = bench["launches"]
    bench_path = ("python -m prefhetch_tpu_torch.bench: SIFT1M core, "
                  "angular, hard; 100K core, encrypted, http, ckks, pq, pir")
    log("done", f"wall {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "union_scan_min",
        "route": "cuda",
        "source": "prefhetch_tpu_torch/csrc/union_scan_min.cu",
        "replaces": "prefhetch_tpu/ops/pallas_scan.py:256",
        "launches": launches["union_scan_min"],
        "launches_per_batch": launches["union_scan_min"] / N_BATCHES,
        "path": f"POST /search x{N_BATCHES}",
        "max_abs_err": max_err,
        "ms": dev_ms,
        "ms_events": min(ms, ms2),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "torch.matmul bf16 [nq,d]x[d,U_real*T], the cross "
                        "term only (a partial function)",
        "launches_http": http["k1_launches"],
        "path_http": f"POST /search x{http['requests']} over HTTP, native "
                     f"frontend, {http['fused_calls']} engine calls in "
                     f"{http['waves']} waves",
        "launches_shard": shard["k1"],
        "path_shard": f"POST /search x{N_BATCHES} on the engine sharded "
                      f"over meshes of 1 and 4 shards of the card, one "
                      f"launch a shard a batch",
        "at_shard_shape": shard["k1_shard"],
        "launches_bench": bench_launches["union_scan_min"],
        "path_bench": bench_path,
        "at_bench_shape": bench["at_shape"]["union_scan_min"],
        "at_headline_shape": k1_headline,
    }, {
        "name": "ntt4_transform",
        "route": "cuda",
        "source": "prefhetch_tpu_torch/csrc/ntt4_step.cu",
        "replaces": "prefhetch_tpu/ops/ntt_pallas.py:246",
        "launches": (enc_launches["ntt4_transform"] + scores_launches
                     + packed_launches + ckks_launches + pir_launches),
        "launches_per_request": k2_per_request,
        "path": f"POST /encryptedsearch x{N_BATCHES} "
                f"({N_BATCHES - 1} full, 1 q1) + encrypted_scores_batch "
                f"({NQ_BATCH} x {cfg.protocol.coarse_probe}) and "
                f"encrypted_scores (1 x {cfg.protocol.coarse_probe}) + "
                f"x{N_BATCHES} packed "
                f"(seedTf) + x{N_BATCHES} ckks combined (seedTf) + 1 ckks "
                f"per-block + {pir_path}",
        "max_abs_err": k2_err,
        **k2_times,
        "at_packed_key_switch_shape": {
            key: k2_packed[key] for key in
            ("ms", "ms_events", "plain_ms", "bound_ms", "bound_by")},
        "at_ckks_key_switch_shape": {
            "shape": [2048, 8192], **k2_ckks},
        "at_pir_key_switch_shape": k2_pir,
        "at_scores_single_shape": {
            "shape": [nbatch // NQ_BATCH, svc.params.n],
            **{key: k2_scores1["forward"][key] for key in
               ("ms", "ms_events", "plain_ms", "bound_ms", "bound_by")}},
        "library_ms": None,
        "per": "transform (one launch)",
        "launches_http_per_request": http["k2_per_request"],
        "launches_shard": shard["k2"],
        "path_shard": "sharded_trunc_mac_q1 (64 queries x 256 candidates, "
                      "meshes of 1 and 4) and DevicePIR2.answer_2d_sharded "
                      "(SIFT1M grid, meshes of 1 and 3)",
        "library_call": "none: no single PyTorch call computes an exact "
                        "modular matrix product",
        "launches_bench": bench_launches["ntt4_transform"],
        "path_bench": bench_path,
        "at_bench_shape": bench["at_shape"]["ntt4_transform"],
    }, {
        "name": "pq_probed_distances",
        "route": "cuda",
        "source": "prefhetch_tpu_torch/csrc/pq_onehot.cu",
        "replaces": "prefhetch_tpu/ops/pallas_scan.py:358",
        **variant_rows["pq_probed_distances"],
        "launches_bench": bench_launches["pq_probed_distances"],
        "path_bench": bench_path,
        "at_bench_shape": bench["at_shape"]["pq_probed_distances"],
    }, {
        "name": "slab_distances_sq8",
        "route": "cuda",
        "source": "prefhetch_tpu_torch/csrc/slab_scan.cu",
        "replaces": "prefhetch_tpu/ops/pallas_scan.py:100",
        **variant_rows["slab_distances_sq8"],
    }, {
        "name": "slab_distances",
        "route": "cuda",
        "source": "prefhetch_tpu_torch/csrc/slab_scan.cu",
        "replaces": "prefhetch_tpu/ops/pallas_scan.py:161",
        **variant_rows["slab_distances"],
    }, {
        "name": "tile_schedule",
        "route": "cuda",
        "source": "prefhetch_tpu_torch/csrc/tile_schedule.cu",
        "replaces": "prefhetch_tpu/ops/pallas_scan.py:183",
        "part_of": "slab_distances_sq8 and slab_distances: the pairs by "
                   "tile, which the TPU grids (:123, :183) walk in order",
        "path": f"query_pipeline(quant=sq8, scan=slab) x{N_BATCHES} each",
        **variant_rows["tile_schedule"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bench-child"]:
        sys.exit(bench_child(sys.argv[2:]))
    sys.exit(main())
