"""The encrypted sections (bench.py ``run_enc`` :756-784,
``encrypted_rerank_qps`` :2029-2129, ``http_encrypted_bench`` :1704-1803,
``ckks_scoring_qps`` :1887-2014, ``_pad_candidates`` :2017-2026).

Every decryption is checked: the BFV distances must equal the plaintext ones
exactly, in process and through the HTTP wire; the CKKS combined response
must lie within CKKS_MAX_REL of the largest distance. A check that fails
raises, and fails its section.
"""

from __future__ import annotations

import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from prefhetch_tpu_torch.bench.core import (
    WORKER_TIMEOUT_S, CheckFailed, run_worker,
)
from prefhetch_tpu_torch.bench.data import (
    COARSE_PROBE, D, K, NPROBE, BenchConfig,
)

CKKS_MAX_REL = 0.01      # bench.py's ckks_max_rel_err at config 3


def pad_candidates(ids: np.ndarray, p: int, nbase: int) -> np.ndarray:
    """[nq, k] candidate ids → [nq, p]: pad with consecutive distinct rows
    after the last id (mod nbase), so the encrypted workloads score exactly
    COARSE_PROBE candidates."""
    ids = ids.astype(np.int64)
    nq, k = ids.shape
    if k >= p:
        return ids[:, :p]
    extra = (ids[:, -1:] + 1 + np.arange(p - k)[None, :]) % nbase
    return np.concatenate([ids, extra], axis=1)


def _first_dev(x) -> None:
    """Wait for a device result by fetching 16 bytes of it."""
    x.reshape(-1)[:4].cpu()


def encrypted_rerank_qps(data, cand_ids: np.ndarray, device, nq: int = 64):
    """BFV N=4096, 2 limbs (BASELINE config 2) on the packed response wire:
    the client encrypts seedTf queries, the service runs the packed program
    (52 K2 launches), the client decrypts exact distances. Batches are
    pipelined with a transfer thread (batch i downloads while batch i+1
    encrypts). Returns (e2e q/s, device q/s — chained dispatches with their
    host work and uploads —, kernel q/s — the program again on its uploaded
    inputs —, the service)."""
    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.engine.hecompute import HEComputeService
    from prefhetch_tpu_torch.utils.config import HEParams

    hc = HEClient(HEParams(resp_mod="packed"), seed=11)
    svc = HEComputeService(hc.params, device=device)
    svc.set_base(data["base"])
    svc.register_galois_keys(hc.key_id, hc.bfv_extraction_keys_wire(D))
    queries = data["query"][:nq].astype(np.float32)
    idx = pad_candidates(cand_ids[:nq], COARSE_PROBE, len(data["base"]))
    ref = ((data["base"][idx].astype(np.float64)
            - queries[:, None, :]) ** 2).sum(-1)

    def check(p_cts, p_norms, p_grp):
        out = hc.decrypt_scores_packed(p_cts, p_norms, queries, p_grp)
        err = float(np.abs(out - ref).max())
        if err != 0.0:
            raise CheckFailed(f"encrypted distances off by {err}")

    def run(wires):
        return svc.encrypted_scores_packed_wire_async(wires, idx, hc.key_id)

    check(*run(hc.encrypt_query_batch(queries))())      # warm
    n_iter = 4
    with ThreadPoolExecutor(max_workers=1) as pool:
        t0 = time.perf_counter()
        fut = None
        for _ in range(n_iter):
            pending = run(hc.encrypt_query_batch(queries))
            if fut is not None:
                check(*fut.result())
            fut = pool.submit(pending)
        check(*fut.result())
        e2e_qps = nq * n_iter / (time.perf_counter() - t0)

    wires = hc.encrypt_query_batch(queries)
    n_mac = 6
    t0 = time.perf_counter()
    for _ in range(n_mac):
        pending = run(wires)
    _first_dev(pending.dev_out)
    mac_qps = nq * n_mac / (time.perf_counter() - t0)
    n_k = 8
    t0 = time.perf_counter()
    for _ in range(n_k):
        dv = pending.program_repeat()
    _first_dev(dv)
    kernel_qps = nq * n_k / (time.perf_counter() - t0)
    return e2e_qps, mac_qps, kernel_qps, svc


def run_enc(cfg: BenchConfig, data, index, cand_ids, device) -> dict:
    """The encrypted section: the in-process packed re-rank, then the same
    wire through HTTP on the warmed service."""
    e_qps, m_qps, k_qps, svc = encrypted_rerank_qps(data, cand_ids, device)
    n_he, b_he = 4096, 4096 // D
    nb_he = -(-COARSE_PROBE // b_he)
    grp = max(1, D // nb_he)          # queries a packed response ct
    out = {
        "encrypted_rerank_qps": e_qps,
        "encrypted_mac_device_qps": m_qps,
        "encrypted_mac_kernel_qps": k_qps,
        # packed single-ct response: 2 comps × 2 limbs × N i32 shared by
        # grp queries, plus per-candidate i32 norms
        "encrypted_wire_bytes_per_query": (
            2 * 2 * n_he * 4 // grp + COARSE_PROBE * 4),
    }
    out.update(http_encrypted_bench(cfg, data, index, cand_ids, device,
                                    he_service=svc))
    return out


def http_encrypted_bench(cfg: BenchConfig, data, index, cand_ids, device,
                         he_service=None, nq: int = 64, n_workers: int = 2,
                         n_iter: int = 4) -> dict:
    """BASELINE config 5 through the wire: out-of-process client workers
    (enc_worker, each thread its own HEClient) encrypt 64-query batches,
    POST /encryptedsearch on the packed wire to the native frontend and
    decrypt. Each worker's first batch is held to the plaintext distances;
    the largest error must be 0."""
    from prefhetch_tpu_torch.engine.server import QueryEngine
    from prefhetch_tpu_torch.serve.native_server import serve_forever_native
    from prefhetch_tpu_torch.utils.config import (
        HEParams, PipelineConfig, ProtocolParams,
    )

    pcfg = PipelineConfig(
        index=cfg.index_params(),
        protocol=ProtocolParams(nprobe=NPROBE, coarse_probe=COARSE_PROBE,
                                k=K, nquery=1),
        nbase=cfg.nbase,
        he=HEParams(resp_mod="packed"),
    )
    engine = QueryEngine(pcfg, device=device)
    engine.set_index(index, data["base"])
    if he_service is not None:      # the warmed in-process service
        engine.he_service = he_service
    queries = data["query"][:nq].astype(np.float32)
    idx = pad_candidates(cand_ids[:nq], COARSE_PROBE, len(data["base"]))
    ref = ((data["base"][idx].astype(np.float64)
            - queries[:, None, :]) ** 2).sum(-1)
    srv = serve_forever_native(engine, port=0, background=True)
    try:
        with tempfile.TemporaryDirectory() as td:
            np.save(os.path.join(td, "queries.npy"), queries)
            np.save(os.path.join(td, "cand.npy"), idx)
            np.save(os.path.join(td, "ref.npy"), ref)
            vals = run_worker(
                "prefhetch_tpu_torch.bench.enc_worker",
                [f"http://127.0.0.1:{srv.port}/", td, n_workers, n_iter],
                WORKER_TIMEOUT_S,
            ).split()
    finally:
        srv.shutdown()
    wall = float(vals[1]) - float(vals[0])
    max_err = float(vals[2])
    if max_err != 0.0:
        raise CheckFailed(f"encrypted distances over HTTP off by {max_err}")
    lats = sorted(float(x) for x in vals[3:])
    return {
        "http_encrypted_qps": nq * len(lats) / wall,
        "http_encrypted_p50_ms": lats[len(lats) // 2] * 1e3,
        "http_encrypted_batch": nq,
        "http_encrypted_max_err": max_err,
        "http_encrypted_workers": n_workers,
    }


def ckks_scoring_qps(data, cand_ids: np.ndarray, device,
                     nq: int = 32) -> dict:
    """BASELINE config 3: CKKS N=8192, the combined single-ct response
    through DeviceCKKS (56 K2 launches a batch) on the parked base, seedTf
    query wires; three pipelined batches, then the device work alone
    (``program_repeat``), then the error of every decrypted distance against
    the plaintext ones over the largest of them."""
    from prefhetch_tpu_torch.crypto.ckks import (
        CKKSContext, extract_combined_ips, rotation_steps,
    )
    from prefhetch_tpu_torch.crypto.params import ckks_params_for
    from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS

    params = ckks_params_for(8192, 26, 3)
    ctx = CKKSContext(params)
    rng = np.random.default_rng(13)   # pinned: the run is reproducible
    sk, _ = ctx.keygen(rng)
    slots = params.n // 2
    per_ct = slots // D
    n_blocks = -(-COARSE_PROBE // per_ct)
    if n_blocks > 1:
        n_blocks = 1 << (n_blocks - 1).bit_length()
    steps = rotation_steps(D) + ctx.combine_tree_steps(n_blocks, D)
    gks = ctx.galois_keygen(sk, steps, rng)
    svc = DeviceCKKS(params, device=device)
    svc.set_base(data["base"].astype(np.float32))
    svc.register_keys("bench", {str(s): k.to_wire() for s, k in gks.items()})

    queries = data["query"][:nq].astype(np.float64)
    idx = pad_candidates(cand_ids[:nq], COARSE_PROBE, len(data["base"]))
    cands = data["base"][idx].astype(np.float64)
    P = cands.shape[1]
    ids32 = idx.astype(np.int32)
    # threefry-seeded symmetric wires: c0 and an 8-byte key a query
    cts = [ctx.encrypt_symmetric_tf(sk, ctx.encode(np.tile(q, slots // D)),
                                    rng)
           for q in queries]

    def run():
        return svc.encrypted_scores_combined_batch_async(cts, ids32, "bench")

    run()()                                    # warm: keys, schedules
    n_it = 3
    t0 = time.perf_counter()
    pend = run()
    for _ in range(n_it - 1):
        nxt = run()
        pend()
        pend = nxt
    res_b, _ = pend()
    qps = nq * n_it / (time.perf_counter() - t0)
    n_dev = 8
    t0 = time.perf_counter()
    for _ in range(n_dev):
        dv = pend.program_repeat()
    _first_dev(dv)
    device_qps = nq * n_dev / (time.perf_counter() - t0)

    max_rel = 0.0
    for i in range(nq):
        ips = extract_combined_ips(ctx.decrypt(sk, res_b[i]), P, D)
        got = (queries[i] ** 2).sum() + (cands[i] ** 2).sum(-1) - 2 * ips
        ref = ((cands[i] - queries[i]) ** 2).sum(-1)
        max_rel = max(max_rel,
                      float(np.abs(got - ref).max() / max(ref.max(), 1.0)))
    if not max_rel <= CKKS_MAX_REL:
        raise CheckFailed(f"ckks_max_rel_err {max_rel} > {CKKS_MAX_REL}")
    return {
        "ckks_scoring_qps": qps,
        "ckks_max_rel_err": max_rel,
        "ckks_device_qps": device_qps,
        # one level-1 result ct: 2 limbs x N x 4 B
        "ckks_wire_kb_per_query": 2 * 1 * params.n * 4 / 1024,
    }
