"""Union-tile batched coarse scan — the port of prefhetch_tpu/ops/union_scan.py.

1. host: dedupe the batch's probed tiles → union list U (clustered query
   batches share most tiles, so |U| ≪ nq·max_t); each query's tiles become
   positions into U;
2. device: score ALL queries against ALL union tiles;
3. device: each query extracts its own tiles' rows by position.

The main path is ``union_scan_pruned_fused``: kernel K1
(ops/union_scan_min.py) scores the union and takes each tile's minimum in
its epilogue, then each query keeps only its j_keep tiles with the smallest
minimum (the minimum bounds every candidate of the tile from below) before
the wide top-k. ``union_scan_distances`` and ``union_scan_pruned`` are the
f32 formulations the JAX package runs through XLA; they stay plain PyTorch
(the unpruned route, the JSON coarse wire and the test oracle), as does
``union_scan_distances_q16``, the tiled binary coarse wire's scan.

The memory-tight configuration scans the raw PQ codes (M bytes per vector)
instead of a dense payload: ``union_pq_scan_distances`` is the exact f32 ADC
over the union (plain PyTorch, the oracle). ``union_pq_scan_distances_kernel``
skips the union: kernel K3 (ops/pq_onehot.py) scores each query against its
own probed tiles only, with bf16 tables, and writes the finished distances.

The union is padded with the empty tile to a multiple of 128 and the empty
tile is always its last entry. The JAX engine also pads the union to a power
of two and the batch rows to a pinned count, only to pin XLA program shapes;
the port drops that padding (results are the same — the tests show it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.ops.pq_onehot import (
    adc_lookup_sum, pq_finish, pq_probed_distances,
)
from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE, topk_smallest
from prefhetch_tpu_torch.ops.union_scan_min import (
    union_distances, union_scan_min,
)
from prefhetch_tpu_torch.utils.wire_bin import Q16_PAD

U_BUCKET = 128


def union_probe_tiles(
    tile_idx: np.ndarray,    # [nq, max_t] int — tile ids incl. empty pads
    empty_tile: int,
    bucket: int = U_BUCKET,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: (union tile ids [U_pad], positions [nq, max_t]).

    positions[qi, k] = index into the union list of tile_idx[qi, k]; the
    union is padded with the empty tile to a bucket multiple, and the empty
    tile is always the union's LAST entry so pad positions point there."""
    uniq, inv = np.unique(tile_idx, return_inverse=True)
    # np.unique sorts ascending and the empty tile has the largest id by
    # construction — but force it to the tail rather than assume
    if uniq[-1] != empty_tile:
        uniq = np.append(uniq, empty_tile)
    u_pad = -(-len(uniq) // bucket) * bucket
    union = np.full(u_pad, empty_tile, tile_idx.dtype)
    union[: len(uniq)] = uniq
    pos = inv.reshape(tile_idx.shape).astype(np.int32)
    return union, pos


def _extract(d2m: torch.Tensor, upos: torch.Tensor) -> torch.Tensor:
    """out[qi, k, :] = d2m[qi, upos[qi, k], :] for d2m [nq, U, T]."""
    T = d2m.shape[2]
    idx = upos.long()[:, :, None].expand(-1, -1, T)
    return torch.gather(d2m, 1, idx)


def union_scan_distances(
    payload: torch.Tensor,   # [ntiles+1, T, d] f32/bf16
    norms: torch.Tensor,     # [ntiles+1, T] f32
    sizes: torch.Tensor,     # [ntiles+1] int32
    queries: torch.Tensor,   # [nq, d] f32
    union: torch.Tensor,     # [U] int32 tile ids
    pos: torch.Tensor,       # [nq, max_t] int32 positions into union
) -> torch.Tensor:
    """Distances [nq, max_t·T] f32 with PAD at invalid lanes."""
    nq = queries.shape[0]
    d2m = union_distances(payload, norms, sizes, queries, union)
    d2m = d2m.permute(2, 0, 1)                              # [nq, U, T]
    return _extract(d2m, pos).reshape(nq, -1)


def union_scan_distances_q16(
    payload: torch.Tensor,   # [ntiles+1, T, d] f32/bf16
    norms: torch.Tensor,     # [ntiles+1, T] f32
    sizes: torch.Tensor,     # [ntiles+1] int32
    queries: torch.Tensor,   # [nq, d] f32
    union: torch.Tensor,     # [U] int32 tile ids
    pos: torch.Tensor,       # [nq, max_t] int32 positions into union
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The union scan with each query's u16 range quantization — the device
    side of the tiled binary coarse wire (utils/wire_bin.py).

    Returns (qdist u16 [nq, max_t·T], dmin f32 [nq], dstep f32 [nq]):
    valid lanes hold round((d − dmin)/dstep) ∈ [0, 65534], invalid lanes
    Q16_PAD. Selection-grade (error ≤ the query's distance spread/65534) at
    2 B a lane; the client rebuilds the mask from its cached tile table."""
    return quantize_q16(
        union_scan_distances(payload, norms, sizes, queries, union, pos))


def quantize_q16(
    out: torch.Tensor,       # [nq, n] f32 distances, PAD at invalid lanes
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query's u16 range quantization of its distances: (qdist u16,
    dmin f32 [nq], dstep f32 [nq]), invalid lanes Q16_PAD."""
    # PAD sorts above any real distance, so the min is safe; the max needs
    # the mask
    vmask = out < PAD_DISTANCE
    dmin = torch.amin(out, dim=1)
    dmax = torch.amax(torch.where(vmask, out, -torch.inf), dim=1)
    dstep = torch.clamp(dmax - dmin, min=1e-20) / 65534.0
    qd = torch.clamp(
        torch.round((out - dmin[:, None]) / dstep[:, None]), 0, 65534
    ).to(torch.int32)
    qd = torch.where(vmask, qd, int(Q16_PAD)).to(torch.uint16)
    return qd, dmin, dstep


def pq_luts(centroids, codebooks, queries, by_residual: bool):
    """The residual LUT of (query q, list p), separated by completing the
    square:

        LUT(q, p)[m, k] = ‖(q − c_p)_m − cb[m, k]‖²
                        = T1(q)[m, k] + T2(p)[m, k] + (terms free of k)
        T1(q)[m, k] = ‖cb[m, k]‖² − 2⟨q_m, cb[m, k]⟩      (per query)
        T2(p)[m, k] = 2⟨c_{p,m}, cb[m, k]⟩                (per list)
        C(q, p)     = ‖q − c_p‖²           (scalar, the k-free terms summed)

    Returns (lut_q [nq, M·ksub], lut_p [nlist, M·ksub] or None without
    residuals, cadd [nq, nlist]), all f32."""
    nq = queries.shape[0]
    M, ksub, dsub = codebooks.shape
    q = queries.to(torch.float32)
    cbsq = torch.sum(codebooks * codebooks, dim=-1)           # [M, ksub]
    lut_q = (cbsq[None] - 2.0 * torch.einsum(
        "qmd,mkd->qmk", q.reshape(nq, M, dsub), codebooks
    )).reshape(nq, M * ksub)
    qsq = torch.sum(q * q, dim=-1)
    if not by_residual:
        return lut_q, None, qsq[:, None].expand(nq, centroids.shape[0])
    cents = centroids.to(torch.float32)
    lut_p = (2.0 * torch.einsum(
        "lmd,mkd->lmk", cents.reshape(-1, M, dsub), codebooks
    )).reshape(-1, M * ksub)
    csq = torch.sum(cents * cents, dim=-1)
    cadd = qsq[:, None] + csq[None, :] - (2.0 * q) @ cents.T
    return lut_q, lut_p, cadd


def union_pq_scan_distances(
    codes: torch.Tensor,      # [ntiles+1, T, M] uint8 — PQ codes payload
    sizes: torch.Tensor,      # [ntiles+1] int32
    tile_list: torch.Tensor,  # [ntiles+1] int32 — owning inverted list
    centroids: torch.Tensor,  # [nlist, d]
    codebooks: torch.Tensor,  # [M, ksub, dsub]
    queries: torch.Tensor,    # [nq, d] f32
    union: torch.Tensor,      # [U] int32 tile ids
    pos: torch.Tensor,        # [nq, max_t] int32 positions into union
    by_residual: bool = True,
) -> torch.Tensor:
    """Exact f32 ADC scan over union code tiles: [nq, max_t·T] distances
    with PAD at invalid lanes — the memory-tight configuration (M bytes per
    vector, FAISS IVFPQ serving-memory parity; no reconstruction payload).
    Plain PyTorch; the oracle of the kernel route below."""
    lut_q, lut_p, cadd = pq_luts(centroids, codebooks, queries, by_residual)
    part = adc_lookup_sum(codes, lut_q, lut_p, tile_list, union)
    return pq_finish(part, cadd, sizes, tile_list, union, pos)


def union_pq_scan_distances_kernel(
    codes: torch.Tensor,      # [ntiles+1, T, M] uint8
    sizes: torch.Tensor,      # [ntiles+1] int32
    tile_list: torch.Tensor,  # [ntiles+1] int32
    centroids: torch.Tensor,  # [nlist, d]
    codebooks: torch.Tensor,  # [M, ksub, dsub]
    queries: torch.Tensor,    # [nq, d]
    tiles: torch.Tensor,      # [nq, max_t] int32 — each query's probed tiles
    by_residual: bool = True,
) -> torch.Tensor:
    """The ADC scan on kernel K3 — the counterpart of the JAX package's
    union_pq_scan_distances_pallas, which scores the union and extracts each
    query's tiles by position; K3 scores the probed tiles directly, so the
    same [nq, max_t·T] distances need no union. The tables are built in f32
    here and K3 looks the codes up in their bf16 roundings. The bf16 tables
    cost a few percent of coarse-distance error (cancellation between the
    ±⟨r, cb⟩ terms), which the exact re-rank downstream absorbs."""
    lut_q, lut_p, cadd = pq_luts(centroids, codebooks, queries, by_residual)
    if lut_p is None:
        lut_p = torch.zeros((centroids.shape[0], lut_q.shape[1]),
                            dtype=torch.float32, device=lut_q.device)
    return pq_probed_distances(codes, lut_q, lut_p, cadd, sizes, tile_list,
                               tiles)


def union_scan_pruned(
    payload: torch.Tensor,   # [ntiles+1, T, d] f32/bf16
    norms: torch.Tensor,     # [ntiles+1, T] f32
    sizes: torch.Tensor,     # [ntiles+1] int32
    queries: torch.Tensor,   # [nq, d] f32
    union: torch.Tensor,     # [U] int32 tile ids
    pos: torch.Tensor,       # [nq, max_t] int32 positions into union
    j_keep: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union scan + segment pruning, f32: (dist [nq, j_keep·T] with PAD at
    invalid lanes, sel [nq, j_keep] — kept slots into the max_t axis,
    ascending by per-tile min distance)."""
    nq = queries.shape[0]
    d2m = union_distances(payload, norms, sizes, queries, union)
    d2m = d2m.permute(2, 0, 1)                              # [nq, U, T]
    dmin = torch.amin(d2m, dim=2)                           # [nq, U]
    return _prune(d2m, dmin, pos, j_keep, nq)


def _prune(d2m, dmin, pos, j_keep, nq):
    """Keep each query's j_keep tiles with the smallest minimum."""
    pos = pos.long()
    tm = torch.gather(dmin, 1, pos)                         # [nq, max_t]
    _, sel = topk_smallest(tm, j_keep)                      # [nq, j]
    upos = torch.gather(pos, 1, sel)                        # → union slot
    return _extract(d2m, upos).reshape(nq, -1), sel


def union_scan_pruned_fused(
    payload: torch.Tensor,   # [ntiles+1, T, d] f32/bf16
    norms: torch.Tensor,     # [ntiles+1, T] f32
    sizes: torch.Tensor,     # [ntiles+1] int32
    queries: torch.Tensor,   # [nq, d] f32
    union: torch.Tensor,     # [U] int32 tile ids
    pos: torch.Tensor,       # [nq, max_t] int32 positions into union
    j_keep: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pruned union scan on kernel K1: same contract as
    union_scan_pruned but distances are bf16 (selection-grade; PAD lanes are
    +inf) and the per-tile min comes from K1's epilogue, so the distance
    matrix is never re-read for it. Only the kept tiles' rows are gathered,
    whole T-lanes at a time from K1's query-major [U, nq, T] layout."""
    U = union.shape[0]
    nq = queries.shape[0]
    d2_all, dmin = union_scan_min(payload, norms, sizes, queries, union)
    dm = dmin.reshape(U, nq).T                              # [nq, U] — tiny
    return _prune(d2_all.transpose(0, 1), dm, pos, j_keep, nq)


def resolve_topk_ids(
    pos: torch.Tensor,        # [nq, k] — positions into the mt·T layout
    tile_idx: torch.Tensor,   # [nq, mt] int — the batch's probed tiles
    ids_table: torch.Tensor,  # [ntiles+1, T] int32 — global ids per slot
) -> torch.Tensor:
    """Map top-k positions in the padded tile layout to global vector ids."""
    T = ids_table.shape[1]
    pos = pos.long()
    trow = torch.gather(tile_idx.long(), 1, pos // T)       # [nq, k]
    return ids_table[trow, pos % T]
