"""The coarse candidate scan over the dense padded index layout — the port
of prefhetch_tpu/ops/scan.py (contract in SURVEY.md §2.3; call site
reference: src/server/server_lib.cpp:126-130).

- The *client* chooses which inverted lists to probe (the server never runs
  quantizer assignment).
- The server returns the coarse distance of EVERY vector in each probed list
  (no top-k, no pruning), the vectors' global ids and the per-query candidate
  counts (ragged ``listSizesPerQuery``).
- Candidate order: probed lists in the client-given order, each list in
  storage order.

The scan emits a fixed [nq, nprobe·lmax] padded tensor with a validity mask;
invalid lanes hold PAD_DISTANCE so a top-k after it needs no masking. The
three functions are plain PyTorch, as they are XLA code in the JAX package,
and serve as the oracles of the slab and ADC kernels (ops/slab_scan.py,
ops/pq_onehot.py). The JAX package's chunking and its ``lax.scan`` over
probes pinned XLA's memory; here one probe is scored at a time, which bounds
memory the same way, and the results are the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE


class ScanResult(NamedTuple):
    distances: torch.Tensor   # [nq, nprobe*lmax] f32, PAD at invalid lanes
    ids: torch.Tensor         # [nq, nprobe*lmax] i32 — global ids, -1 pad
    mask: torch.Tensor        # [nq, nprobe*lmax] bool — True = candidate
    counts: torch.Tensor      # [nq] i32 — Σ probed list sizes


def _per_probe(list_ids, list_sizes, probe_ids, probe_d2) -> ScanResult:
    """Run ``probe_d2(lids [nq]) -> d2 [nq, lmax]`` for every probe slot,
    mask past each list's size and lay the slots out probe-major."""
    probe_ids = probe_ids.long()
    nq, nprobe = probe_ids.shape
    lmax = list_ids.shape[1]
    lane = torch.arange(lmax, device=list_ids.device)
    sizes_p = list_sizes[probe_ids]                           # [nq, nprobe]
    valid = lane[None, None, :] < sizes_p[:, :, None]         # [nq, np, lmax]
    d2 = torch.stack(
        [probe_d2(probe_ids[:, p]) for p in range(nprobe)], dim=1
    )
    d2 = torch.where(valid, d2, PAD_DISTANCE)
    return ScanResult(
        d2.reshape(nq, -1),
        list_ids[probe_ids].reshape(nq, -1),
        valid.reshape(nq, -1),
        sizes_p.sum(dim=1).to(torch.int32),
    )


def coarse_scan_flat(
    list_vectors: torch.Tensor,   # [nlist, lmax, d] f32 or bf16
    list_ids: torch.Tensor,       # [nlist, lmax]
    list_sizes: torch.Tensor,     # [nlist]
    queries: torch.Tensor,        # [nq, d]
    probe_ids: torch.Tensor,      # [nq, nprobe] — client-chosen list ids
    list_norms: Optional[torch.Tensor] = None,   # [nlist, lmax] ‖payload‖²
) -> ScanResult:
    """Dense candidate scan: squared L2 of every candidate in the probed
    lists (payload = raw vectors for IVF-Flat, bf16 reconstructions for the
    IVF-PQ fast path). The payload is widened to f32 and the queries stay
    f32, so a bf16 payload's products are exact."""
    queries = queries.to(torch.float32)
    qsq = torch.sum(queries * queries, dim=-1)                # [nq]
    if list_norms is None:
        list_norms = torch.sum(list_vectors.to(torch.float32) ** 2, dim=-1)

    def probe_d2(lids):
        vecs = list_vectors[lids].to(torch.float32)           # [nq, lmax, d]
        cross = torch.bmm(vecs, queries[:, :, None])[..., 0]
        return torch.clamp(
            qsq[:, None] + list_norms[lids] - 2.0 * cross, min=0.0
        )

    return _per_probe(list_ids, list_sizes, probe_ids, probe_d2)


def coarse_scan_sq8(
    list_sq: torch.Tensor,        # [nlist, lmax, d] uint8
    sq_vmin: torch.Tensor,        # [d]
    sq_scale: torch.Tensor,       # [d]
    list_ids: torch.Tensor,       # [nlist, lmax]
    list_sizes: torch.Tensor,     # [nlist]
    queries: torch.Tensor,        # [nq, d]
    probe_ids: torch.Tensor,      # [nq, nprobe]
) -> ScanResult:
    """IVF-SQ8 scan: gather 8-bit codes (d bytes/vector), decode
    x̂ = vmin + (code + ½)·scale, then the same dense distance."""
    queries = queries.to(torch.float32)
    qsq = torch.sum(queries * queries, dim=-1)

    def probe_d2(lids):
        codes = list_sq[lids].to(torch.float32)               # [nq, lmax, d]
        vecs = sq_vmin + (codes + 0.5) * sq_scale
        vsq = torch.sum(vecs * vecs, dim=-1)
        cross = torch.bmm(vecs, queries[:, :, None])[..., 0]
        return torch.clamp(qsq[:, None] + vsq - 2.0 * cross, min=0.0)

    return _per_probe(list_ids, list_sizes, probe_ids, probe_d2)


def coarse_scan_pq(
    centroids: torch.Tensor,      # [nlist, d]
    list_codes: torch.Tensor,     # [nlist, lmax, M] uint8 (or any int)
    list_ids: torch.Tensor,       # [nlist, lmax]
    list_sizes: torch.Tensor,     # [nlist]
    codebooks: torch.Tensor,      # [M, ksub, dsub]
    queries: torch.Tensor,        # [nq, d]
    probe_ids: torch.Tensor,      # [nq, nprobe]
    by_residual: bool = True,
) -> ScanResult:
    """IVF-PQ ADC scan: per (query, probed list) the asymmetric-distance
    lookup table over the query *residual* (FAISS IndexIVFPQ by_residual
    semantics), then the candidate distance is Σ_m lut[m, code_m]."""
    queries = queries.to(torch.float32)
    nq = queries.shape[0]
    M, ksub, dsub = codebooks.shape
    lmax = list_ids.shape[1]
    cbsq = torch.sum(codebooks * codebooks, dim=-1)           # [M, ksub]
    m_offset = torch.arange(M, device=queries.device) * ksub  # [M]

    def probe_d2(lids):
        res = queries - centroids[lids] if by_residual else queries
        rsub = res.reshape(nq, M, dsub)
        rsq = torch.sum(rsub * rsub, dim=-1)                  # [nq, M]
        cross = torch.einsum("qmd,mkd->qmk", rsub, codebooks)
        lut = rsq[:, :, None] + cbsq[None] - 2.0 * cross      # [nq, M, ksub]
        idx = (list_codes[lids].long() + m_offset).reshape(nq, lmax * M)
        vals = torch.gather(lut.reshape(nq, M * ksub), 1, idx)
        return torch.sum(vals.reshape(nq, lmax, M), dim=-1)   # [nq, lmax]

    return _per_probe(list_ids, list_sizes, probe_ids, probe_d2)
