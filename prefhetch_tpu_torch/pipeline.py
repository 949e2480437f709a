"""The full triage query step over the tiled layout, in its scan variants —
the port of bench.py ``tpu_pipeline`` (bench.py:199-482).

    client centroid ranking → probe → tile expansion (host) → coarse scan →
    top-COARSE_PROBE → id resolve → exact re-rank → top-K

``query_pipeline`` prepares one batch and returns ``(step, args, stats)``:
``step(*args)`` runs the batch's device work and returns (distances [nq, k]
ascending, ids [nq, k]); ``stats["stage_fns"](args)`` returns the three
stages (scan, topk, tail) as zero-argument functions over the same tensors,
for per-stage timing. The scan is one of five:

- ``quant="pq"``   — PQ codes payload (M bytes per vector, FAISS IVFPQ
  serving-memory parity), ADC over each query's probed tiles on kernel K3
  (ops/union_scan.union_pq_scan_distances_kernel; no union is built);
- ``quant="sq8"``  — per-dimension 8-bit payload, per-(query, tile) slab
  distances on kernel K4 (ops/slab_scan.slab_distances_sq8);
- ``scan="union"`` with tile pruning — kernel K1 over the union tiles, each
  query keeps its ``prune_j`` best tiles (ops/union_scan
  .union_scan_pruned_fused);
- ``scan="union"`` without pruning — the unfused f32 union scan;
- ``scan="slab"``  — dense payload, slab distances on kernel K5
  (ops/slab_scan.slab_distances).

bench.py's ``PFH_BENCH_*`` environment variables are the arguments here.
Its switches between Pallas and XLA formulations are not ported: on the
card each variant runs its kernel, and on CPU tensors each kernel's wrapper
takes its plain version.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.index.tiling import TiledView, build_tiled_view
from prefhetch_tpu_torch.index.types import IVFIndex
from prefhetch_tpu_torch.ops.distances import rank_centroids
from prefhetch_tpu_torch.ops.rerank import exact_rerank
from prefhetch_tpu_torch.ops.slab_scan import (
    slab_distances, slab_distances_sq8,
)
from prefhetch_tpu_torch.ops.topk import (
    PAD_DISTANCE, topk_select_segmented, topk_smallest,
)
from prefhetch_tpu_torch.ops.union_scan import (
    union_pq_scan_distances_kernel, union_probe_tiles, union_scan_distances,
    union_scan_pruned_fused,
)


def default_tile(quant: str) -> int:
    """256-slot tiles for the PQ codes payload, else 1024."""
    return 256 if quant == "pq" else 1024


def query_pipeline(
    index: IVFIndex,
    base,                          # [nbase, d] f32, tensor or numpy
    queries,                       # [nq, d], tensor or numpy
    nprobe: int = 16,
    coarse_probe: int = 256,
    k: int = 100,
    quant: str = "none",           # "none" | "sq8" | "pq"
    scan: str = "union",           # "union" | "slab" (quant="none" only)
    tile: Optional[int] = None,
    prune_j: Optional[int] = None,  # kept tiles per query; 0 = no pruning
    device: "str | torch.device" = "cuda",
    view: Optional[TiledView] = None,
) -> Tuple[Callable, tuple, dict]:
    """Prepare one query batch; returns (step, args, stats).

    ``view`` is a tiled view built earlier with the same ``quant`` and
    ``tile`` (``build_tiled_view``), so several batches share one re-pack;
    by default the view is built here. ``prune_j`` defaults to 24 tiles per
    256 of ``coarse_probe``, bounded by the batch's tile axis, and is
    dropped when it cannot cover ``coarse_probe``."""
    dev = resolve_device(device)
    if index.device != dev:
        raise ValueError(f"index is on {index.device}, pipeline on {dev}")
    if quant not in ("none", "sq8", "pq"):
        raise ValueError(f"unknown quant {quant!r}")
    if scan not in ("union", "slab"):
        raise ValueError(f"unknown scan {scan!r}")
    if view is None:
        view = build_tiled_view(
            index, tile=default_tile(quant) if tile is None else tile,
            quant=quant,
        )
    if view is None:
        raise ValueError(f"the index has no payload for quant={quant!r}")
    T = view.tile
    base_t = torch.as_tensor(base, dtype=torch.float32, device=dev)
    q_t = torch.as_tensor(queries, dtype=torch.float32, device=dev)

    # stage 3 of the protocol is client work (it ranks the downloaded
    # centroids)
    _, probes = rank_centroids(q_t, index.centroids, nprobe)
    tiles_np, _ = view.expand_probes(probes.cpu().numpy())
    tiles_t = torch.from_numpy(tiles_np).to(dev)
    max_t = tiles_np.shape[1]

    j = 0                           # set by the union branch; 0 = no pruning
    union_t = pos_t = None
    if quant == "none" and scan == "union":
        union_np, pos_np = union_probe_tiles(tiles_np, view.empty_tile)
        union_t = torch.from_numpy(union_np.astype(np.int32)).to(dev)
        pos_t = torch.from_numpy(pos_np).to(dev)

    if quant == "pq":
        tile_list_t = torch.from_numpy(view.tile_list_np).to(dev)
        by_res = bool(index.params.by_residual)

        def prog_scan(payload, norms, sizes, q, tiles):
            return union_pq_scan_distances_kernel(
                payload, sizes, tile_list_t, index.centroids,
                index.codebooks, q, tiles, by_residual=by_res,
            )
    elif quant == "sq8":
        def prog_scan(payload, norms, sizes, q, tiles):
            return slab_distances_sq8(
                payload, norms, sizes, view.sq_vmin, view.sq_scale, q, tiles
            )
    elif scan == "union":
        # segment-level pruning: hand selection only the j most promising
        # tiles per query (per-tile minimum as the prefilter); j must keep
        # j·T ≥ coarse_probe
        j = 24 * max(1, coarse_probe // 256) if prune_j is None else prune_j
        j = min(int(j), max_t)
        if j * T < coarse_probe:
            j = 0
        if j:
            def prog_scan(payload, norms, sizes, q, tiles):
                return union_scan_pruned_fused(
                    payload, norms, sizes, q, union_t, pos_t, j
                )
        else:
            def prog_scan(payload, norms, sizes, q, tiles):
                return union_scan_distances(
                    payload, norms, sizes, q, union_t, pos_t
                )
    else:
        def prog_scan(payload, norms, sizes, q, tiles):
            return slab_distances(payload, norms, sizes, q, tiles)

    n_seg = j or max_t

    def prog_topk(dist):
        return topk_select_segmented(
            dist, coarse_probe, n_seg, level1_bf16=True
        )

    def prog_tail(tile_ids, tiles, pos, base, q, sel=None):
        # resolve top positions → global ids: pos = tile_slot·T + lane
        # (under pruning the tile axis was compacted to the kept slots sel)
        tiles = tiles.long()
        if sel is not None:
            tiles = torch.gather(tiles, 1, sel.long())
        tile_sel = torch.gather(tiles, 1, pos // T)
        cand = tile_ids[tile_sel, pos % T]
        pad = cand < 0                 # PAD lanes (id −1): clamp for the
        cand = torch.clamp(cand, min=0)  # gather, then bar them from the
        pd = exact_rerank(base, q, cand)  # final top-k explicitly
        pd = torch.where(pad, PAD_DISTANCE, pd)
        vals, order = topk_smallest(pd, k)
        return vals, torch.gather(cand, 1, order)

    def scan_out(out):
        """(dist, sel): only the pruned scan returns kept slots."""
        return out if j else (out, None)

    def step(payload, norms, sizes, ids, base, q, tiles):
        dist, sel = scan_out(prog_scan(payload, norms, sizes, q, tiles))
        _, pos = prog_topk(dist)
        return prog_tail(ids, tiles, pos, base, q, sel)

    def stage_fns(run_args):
        payload, norms, sizes, ids, base, q, tiles = run_args

        def scan_fn():
            return prog_scan(payload, norms, sizes, q, tiles)

        dist, sel = scan_out(scan_fn())

        def topk_fn():
            return prog_topk(dist)

        _, pos = topk_fn()

        def tail_fn():
            return prog_tail(ids, tiles, pos, base, q, sel)

        return {"scan": scan_fn, "topk": topk_fn, "tail": tail_fn}

    args = (view.payload, view.norms, view.sizes, view.ids, base_t, q_t,
            tiles_t)
    row_bytes = view.payload.shape[2] * view.payload.element_size() + 4
    if union_t is not None:
        # union scans read each deduped tile ONCE per batch
        scan_bytes = int(union_t.shape[0] * T * row_bytes
                         / max(q_t.shape[0], 1))
    else:
        scan_bytes = int(max_t * T * row_bytes)
    stats = {
        "tiles_per_query": float(max_t),
        # payload + ids bytes read per query by the scan (amortized across
        # the batch for the union scans)
        "scan_bytes_per_query": scan_bytes,
        "stage_fns": stage_fns,
        "prune_j": j,
        "view": view,
        "union": union_t,
        "pos": pos_t,
    }
    return step, args, stats
