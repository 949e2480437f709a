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
(the unpruned route and the test oracle).

The union is padded with the empty tile to a multiple of 128 and the empty
tile is always its last entry. The JAX engine also pads the union to a power
of two and the batch rows to a pinned count, only to pin XLA program shapes;
the port drops that padding (results are the same — the tests show it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.ops.topk import topk_smallest
from prefhetch_tpu_torch.ops.union_scan_min import (
    union_distances, union_scan_min,
)

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
