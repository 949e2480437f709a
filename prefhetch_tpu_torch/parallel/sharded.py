"""Sharded index services over a device mesh — the port of
prefhetch_tpu/parallel/sharded.py.

Sharding layout (the EP/DP analog for an ANN index — SURVEY.md §2.4, §5.8):

- inverted lists sharded along the ``nlist`` axis (each shard owns
  nlist/ndev contiguous lists and their codes, vectors and ids),
- the raw base matrix sharded along the ``nbase`` axis (exact re-rank and
  retrieval), and the tiled view along its tile axis,
- centroids, codebooks, tile id table and queries replicated (small),
- combination by the mesh's collectives (parallel/mesh.py): a sum of masked
  partials where the JAX package psums or all_gathers and selects.

Each ``shard_map`` body of the JAX package is a loop over the mesh's local
shards here. Every candidate slot is owned by exactly one shard, so the
owner's value plus exact zeros is the single-device value. The port takes
that sum on the values' bit patterns (``_owner_sum``), so a −0.0 or a PAD
passes unchanged. Each shard computes a (query, candidate) value by the
arithmetic of the port's unsharded service: the dense scans and the re-rank
at the unsharded shapes (probes and ids localised and clipped, not
dropped), the union scans through ``union_distances`` (which multiplies a
fixed number of tiles at a time) or kernel K1 (one block a tile). Results
are bit-equal to one device's; only ``sharded_kmeans_step``'s float sums
depend on the order of the shards.

A "sharded" tensor is a ``ShardedRows``: this process's row shards, each on
its shard's device; a shard on the device of the unsharded tensor is a view
of it. Replicated inputs and results live on the mesh's leader device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.index.types import IVFIndex
from prefhetch_tpu_torch.ops.rerank import exact_rerank, final_topk
from prefhetch_tpu_torch.ops.scan import (
    ScanResult, coarse_scan_flat, coarse_scan_pq, coarse_scan_sq8,
)
from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE, topk_smallest
from prefhetch_tpu_torch.ops.union_scan import _extract, quantize_q16
from prefhetch_tpu_torch.ops.union_scan_min import (
    union_distances, union_scan_min,
)
from prefhetch_tpu_torch.parallel.mesh import Mesh

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _owner_sum(mesh: Mesh, parts) -> torch.Tensor:
    """parts: per local shard (value, owned), ``owned`` broadcastable to the
    value. Every element has exactly one owner over the mesh: the sum of
    the owners' values and zeros, taken on integer bit patterns (16-bit
    ones widened for the collective), on the leader device."""
    dtype = parts[0][0].dtype
    bits = _BITS.get(dtype)
    acc = []
    for v, owned in parts:
        if bits is not None:
            v = v.view(bits)
        v = v.to(torch.int32) if v.dtype in (torch.int16, torch.bool) else v
        acc.append(torch.where(owned, v, torch.zeros((), dtype=v.dtype,
                                                     device=v.device)))
    out = mesh.psum(acc)
    if bits is not None:
        return out.to(bits).view(dtype)
    return out.to(dtype)


def _localize(ids: torch.Tensor, gid: int, n_local: int):
    """Global ids → (clipped local ids, owned) on shard ``gid``."""
    local = ids.long() - gid * n_local
    owned = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), owned


# ---------------------------------------------------------------------------
# the index and the base matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedRows:
    """Row shards of a [rows, ...] tensor: ``shards[i]`` [rows_l, ...] on
    the mesh's i-th local device; global row r lives on shard r // rows_l.
    ``nrows`` is the unpadded count (negative ids wrap by it, as torch
    indexing of the unsharded tensor does)."""

    shards: List[torch.Tensor]
    rows_l: int
    nrows: int


def shard_rows(x, mesh: Mesh, pad: bool = False) -> ShardedRows:
    """This process's row shards of ``x`` (tensor or numpy array). The rows
    must divide by the mesh, unless ``pad``: then the last shards hold zero
    rows past the end (no id reaches them). A shard wholly inside ``x`` on
    ``x``'s device is a view."""
    x = torch.as_tensor(x)
    nrows = x.shape[0]
    ndev = mesh.ndev
    if nrows % ndev and not pad:
        raise ValueError(f"rows={nrows} not divisible by {ndev} devices")
    rows_l = -(-nrows // ndev)
    shards = []
    for gid, dev in mesh.local_shards():
        lo, hi = gid * rows_l, (gid + 1) * rows_l
        part = x[lo:hi].to(dev)
        if part.shape[0] < rows_l:
            fill = torch.zeros((rows_l - part.shape[0],) + x.shape[1:],
                               dtype=x.dtype, device=dev)
            part = torch.cat([part, fill])
        shards.append(part)
    return ShardedRows(shards, rows_l, nrows)


@dataclasses.dataclass
class ShardedIndex:
    """List-sharded twin of IVFIndex: ``shards[i]`` holds the nlist/ndev
    lists of the i-th local shard (its centroids too, so that LOCAL list ids
    index the right centroid rows for the by-residual tables); codebooks and
    SQ8 affine terms are replicated."""

    shards: List[IVFIndex]

    @property
    def nlist_local(self) -> int:
        return self.shards[0].nlist


def shard_index(index: IVFIndex, mesh: Mesh) -> ShardedIndex:
    """List-sharded views of the index (copies only on another device).
    nlist must divide evenly by the mesh size (presets use powers of two)."""
    ndev = mesh.ndev
    if index.nlist % ndev != 0:
        raise ValueError(f"nlist={index.nlist} not divisible by {ndev} devices")
    nl = index.nlist // ndev
    rows = ("centroids", "list_ids", "list_sizes", "list_vectors",
            "list_codes", "list_sq", "list_recon", "list_norms")
    rep = ("codebooks", "sq_vmin", "sq_scale")
    shards = []
    for gid, dev in mesh.local_shards():
        kw = {}
        for f in rows + rep:
            t = getattr(index, f)
            if t is not None:
                kw[f] = (t[gid * nl:(gid + 1) * nl] if f in rows else t).to(dev)
        shards.append(IVFIndex(params=index.params, **kw))
    return ShardedIndex(shards)


def _scan_shard(idx: IVFIndex, q, p) -> ScanResult:
    """The port's unsharded dense scan on one shard's lists, in the branch
    order of QueryEngine.coarse_search."""
    if idx.list_sq is not None:
        return coarse_scan_sq8(idx.list_sq, idx.sq_vmin, idx.sq_scale,
                               idx.list_ids, idx.list_sizes, q, p)
    if idx.uses_pq and idx.list_recon is not None:
        return coarse_scan_flat(idx.list_recon, idx.list_ids,
                                idx.list_sizes, q, p, idx.list_norms)
    if idx.uses_pq:
        return coarse_scan_pq(idx.centroids, idx.list_codes, idx.list_ids,
                              idx.list_sizes, idx.codebooks, q, p,
                              by_residual=idx.params.by_residual)
    return coarse_scan_flat(idx.list_vectors, idx.list_ids, idx.list_sizes,
                            q, p, idx.list_norms)


def sharded_coarse_scan(
    mesh: Mesh, index: ShardedIndex, queries, probe_ids
) -> ScanResult:
    """Multi-shard all-candidate scan, bit-equal to the single-device dense
    scan (ops/scan.py): every shard scores every probe slot at the unsharded
    shapes on its clipped local list, keeps the slots it owns, and the
    owners' values combine."""
    nl = index.nlist_local
    q = torch.as_tensor(queries, dtype=torch.float32)
    probes = torch.as_tensor(probe_ids).long()
    dist, ids, mask, counts = [], [], [], []
    for (gid, dev), shard in zip(mesh.local_shards(), index.shards):
        local, owned = _localize(probes.to(dev), gid, nl)
        res = _scan_shard(shard, q.to(dev), local)
        lmax = shard.lmax
        own3 = owned[:, :, None].expand(-1, -1, lmax).reshape(owned.shape[0],
                                                              -1)
        m = res.mask & own3
        dist.append((res.distances, m))
        ids.append((res.ids.to(torch.int32) + 1, m))   # −1 pads → 0
        mask.append((m, m))
        counts.append(torch.where(owned, shard.list_sizes[local], 0).sum(1))
    m = _owner_sum(mesh, mask).to(torch.bool)
    return ScanResult(
        torch.where(m, _owner_sum(mesh, dist), PAD_DISTANCE),
        _owner_sum(mesh, ids) - 1,
        m,
        mesh.psum(counts).to(torch.int32),
    )


def _wrap(ids, rows: ShardedRows) -> torch.Tensor:
    """Negative ids wrap as in torch indexing of the unsharded tensor."""
    ids = torch.as_tensor(ids).long()
    return torch.where(ids < 0, ids + rows.nrows, ids)


def sharded_rerank(
    mesh: Mesh, base: ShardedRows, queries, cand_ids
) -> torch.Tensor:
    """Exact re-rank [nq, P] with the base row-sharded: each shard scores
    the candidates it owns (exact_rerank at the unsharded shape) and the
    owners' values combine."""
    q = torch.as_tensor(queries, dtype=torch.float32)
    cand = _wrap(cand_ids, base)
    parts = []
    for (gid, dev), b in zip(mesh.local_shards(), base.shards):
        local, owned = _localize(cand.to(dev), gid, base.rows_l)
        parts.append((exact_rerank(b, q.to(dev), local), owned))
    return _owner_sum(mesh, parts)


def sharded_fetch(mesh: Mesh, base: ShardedRows, ids) -> torch.Tensor:
    """Vector retrieval [nq, K, d] with the base row-sharded (the
    /precise-vector-pir placeholder endpoint)."""
    ids = _wrap(ids, base)
    parts = []
    for (gid, dev), b in zip(mesh.local_shards(), base.shards):
        local, owned = _localize(ids.to(dev), gid, base.rows_l)
        parts.append((b[local], owned[..., None]))
    return _owner_sum(mesh, parts)


def sharded_kmeans_step(
    mesh: Mesh, x: ShardedRows, centroids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One data-parallel Lloyd iteration: each shard accumulates partial
    (sums, counts) over its rows, a psum combines them, the update is
    replicated → (new centroids [k, d], counts [k] f32). The float sums
    depend on the order of the shards: equal to one device's up to f32
    rounding (the JAX test holds means to rtol 1e-4). Row-padding zero
    rows must not be passed (they would join a cluster)."""
    c = torch.as_tensor(centroids, dtype=torch.float32)
    k, d = c.shape
    sums, counts = [], []
    for (_, dev), xl in zip(mesh.local_shards(), x.shards):
        cl = c.to(dev)
        csq = torch.sum(cl * cl, dim=-1)
        a = torch.argmin(csq[None, :] - 2.0 * (xl @ cl.T), dim=-1)
        s = torch.zeros((k, d), dtype=torch.float32, device=dev)
        s.index_add_(0, a, xl.to(torch.float32))
        sums.append(s)
        counts.append(torch.bincount(a, minlength=k).to(torch.float32))
    sums = mesh.psum(sums)
    cnt = mesh.psum(counts)
    return sums / torch.clamp(cnt, min=1.0)[:, None], cnt


# ---------------------------------------------------------------------------
# the tiled union scans: tiles are the shard unit. Each shard owns a
# contiguous tile range of the payload, norms and sizes, scores ONLY its share
# of the batch's union and extracts the (query, slot) rows it owns.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedTiledView:
    """Tile-sharded twin of index.tiling.TiledView's device tensors."""

    payload: List[torch.Tensor]   # [tpl, T, d] a local shard
    norms: List[torch.Tensor]     # [tpl, T]
    sizes: List[torch.Tensor]     # [tpl]
    ids: torch.Tensor             # [ntiles+1, T] replicated (tail resolve)
    ntp: int                      # padded tile count (ndev multiple)
    tpl: int                      # tiles a shard: owner = tile // tpl


def shard_tiled_view(view, mesh: Mesh) -> ShardedTiledView:
    """Pad the tile axis to a mesh multiple with size-0 tiles (no union
    references them) and shard payload, norms and sizes by tile ranges; the
    id table stays replicated."""
    p = shard_rows(view.payload, mesh, pad=True)
    n = shard_rows(view.norms, mesh, pad=True)
    s = shard_rows(view.sizes, mesh, pad=True)
    return ShardedTiledView(p.shards, n.shards, s.shards,
                            view.ids.to(mesh.leader), p.rows_l * mesh.ndev,
                            p.rows_l)


def partition_union(
    union_np, pos_np, empty_tile: int, tpl: int, ndev: int,
    u_loc: Optional[int] = None,
):
    """Host side: split the batch's union across tile owners.

    Returns (union_dev [ndev, u_loc] i32 — global tile ids, −1 pads;
    pos_dev [nq, mt] i32 — positions into the dev-major concatenated layout
    slot = owner·u_loc + local_slot; u_loc). Duplicate empty-tile entries of
    the union collapse onto its first occurrence so they never inflate one
    shard's share. u_loc is the largest share unless the caller pins a
    larger one (the JAX package rounds it to a power of two to pin XLA
    shapes; the port pins nothing)."""
    union_np = np.asarray(union_np)
    first = int(np.argmax(union_np == empty_tile))
    keep = np.ones(len(union_np), bool)
    tail = union_np[first + 1:] == empty_tile
    keep[first + 1:][tail] = False
    owner = (union_np // tpl).astype(np.int64)
    slot_of = np.empty(len(union_np), np.int64)
    counts = np.zeros(ndev, np.int64)
    kept_idx = np.nonzero(keep)[0]
    for d in range(ndev):
        sel = kept_idx[owner[kept_idx] == d]
        counts[d] = len(sel)
        slot_of[sel] = np.arange(len(sel))
    need = max(1, int(counts.max()))
    if u_loc is None or u_loc < need:
        u_loc = need
    union_dev = np.full((ndev, u_loc), -1, np.int32)
    for d in range(ndev):
        sel = kept_idx[owner[kept_idx] == d]
        union_dev[d, : len(sel)] = union_np[sel]
    slot_of = slot_of + owner * u_loc
    # dropped duplicate empty entries point at the kept one
    slot_of[~keep] = slot_of[first]
    pos_dev = slot_of[np.asarray(pos_np)].astype(np.int32)
    return union_dev, pos_dev, u_loc


def _shard_unions(mesh: Mesh, st: ShardedTiledView, union_dev, pos_dev):
    """Per local shard (gid, dev, local tile ids [u_loc] i32 — −1 pads
    clipped to tile 0, never extracted — pos [nq, mt] on dev); u_loc."""
    union_dev = torch.as_tensor(union_dev).cpu()
    pos = torch.as_tensor(pos_dev).long()
    u_loc = union_dev.shape[1]
    out = []
    for gid, dev in mesh.local_shards():
        uid = union_dev[gid].long()
        loc = (uid - gid * st.tpl).clamp(0, st.tpl - 1).to(torch.int32)
        out.append((gid, dev, loc.to(dev), pos.to(dev)))
    return out, u_loc


def _mine(pos, gid: int, u_loc: int):
    """(slots of pos that shard gid owns, their local union slots)."""
    mine = (pos // u_loc) == gid
    return mine, torch.where(mine, pos % u_loc, 0)


def sharded_union_scan(
    mesh: Mesh, st: ShardedTiledView, queries, union_dev, pos_dev,
) -> torch.Tensor:
    """[nq, mt·T] f32 distances, PAD at invalid lanes, on the leader —
    sharded twin of ops/union_scan.union_scan_distances, bit-equal to it."""
    q = torch.as_tensor(queries, dtype=torch.float32)
    shards, u_loc = _shard_unions(mesh, st, union_dev, pos_dev)
    nq = q.shape[0]
    parts = []
    for i, (gid, dev, loc, pos) in enumerate(shards):
        d2m = union_distances(st.payload[i], st.norms[i], st.sizes[i],
                              q.to(dev), loc).permute(2, 0, 1)
        mine, ls = _mine(pos, gid, u_loc)
        parts.append((_extract(d2m, ls), mine[:, :, None]))
    return _owner_sum(mesh, parts).reshape(nq, -1)


def sharded_union_scan_q16(
    mesh: Mesh, st: ShardedTiledView, queries, union_dev, pos_dev,
):
    """(qd u16 [nq, mt·T], dmin, dstep) — sharded twin of
    union_scan_distances_q16 (the tiled binary coarse wire)."""
    return quantize_q16(
        sharded_union_scan(mesh, st, queries, union_dev, pos_dev))


def sharded_union_scan_pruned(
    mesh: Mesh, st: ShardedTiledView, queries, union_dev, pos_dev,
    j_keep: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist bf16 [nq, j·T], sel [nq, j]) — sharded twin of
    ops/union_scan.union_scan_pruned_fused, bit-equal to it: kernel K1 once
    a shard over its union share (d2 and each tile's minimum), the owners'
    tile minima combined, the same stable top-j_keep of them on the leader,
    then the kept tiles' rows from their owners. The JAX package runs the
    f32 formulation here; the port runs the kernel its unsharded route
    runs."""
    q = torch.as_tensor(queries, dtype=torch.float32)
    shards, u_loc = _shard_unions(mesh, st, union_dev, pos_dev)
    nq = q.shape[0]
    scans, tms = [], []
    for i, (gid, dev, loc, pos) in enumerate(shards):
        d2, dmin = union_scan_min(st.payload[i], st.norms[i], st.sizes[i],
                                  q.to(dev), loc)
        scans.append(d2.transpose(0, 1))                 # [nq, u_loc, T]
        mine, ls = _mine(pos, gid, u_loc)
        dm = dmin.reshape(u_loc, nq).T
        tms.append((torch.gather(dm, 1, ls), mine))
    tm = _owner_sum(mesh, tms)                           # [nq, mt]
    pos_l = torch.as_tensor(pos_dev).long().to(mesh.leader)
    _, sel = topk_smallest(tm, j_keep)                   # [nq, j]
    upos = torch.gather(pos_l, 1, sel)
    parts = []
    for (gid, dev, _, _), d2m in zip(shards, scans):
        mine, ls = _mine(upos.to(dev), gid, u_loc)
        parts.append((_extract(d2m, ls), mine[:, :, None]))
    return _owner_sum(mesh, parts).reshape(nq, -1), sel


def sharded_fused_tail(
    mesh: Mesh, base: ShardedRows, queries, cand_ids, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [nq, k], dists [nq, k]) ascending — the fused route's exact
    re-rank with the base row-sharded, then the final select, as
    ops/rerank.final_topk after exact_rerank."""
    cand = torch.as_tensor(cand_ids).to(mesh.leader)
    scores = sharded_rerank(mesh, base, queries, cand)
    return final_topk(scores, cand, int(k))


# ---------------------------------------------------------------------------
# encrypted services sharded: the BFV truncated MAC (q1 wire)
# ---------------------------------------------------------------------------

def pad_rows_for_mesh(base_pad, ndev: int):
    """Pad a [rows, d] int32 matrix with zero rows to a multiple of ndev
    (the appended rows can never be indexed: callers clamp idx to the
    original padding row, and zero rows MAC to zero anyway)."""
    rows = base_pad.shape[0]
    want = -(-rows // ndev) * ndev
    if want == rows:
        return base_pad
    return np.concatenate(
        [base_pad, np.zeros((want - rows, base_pad.shape[1]),
                            base_pad.dtype)]
    )


@functools.lru_cache(maxsize=None)
def _mac_service(params, device: torch.device):
    """An HEComputeService holding nothing but the tables, for the q1 MAC
    core on ``device``."""
    from prefhetch_tpu_torch.engine.hecompute import HEComputeService

    return HEComputeService(params, device=device)


def sharded_trunc_mac_q1(
    mesh: Mesh, base: ShardedRows, ctq, idx, params,
) -> torch.Tensor:
    """Row/query-sharded BFV truncated MAC (q1 wire) — the encrypted
    re-rank service (engine/hecompute.encrypted_scores_trunc_q1) over a
    mesh, bit-equal to one device's: [nq, nb, N+B] int32 on the leader.

    The candidate base is row-sharded; each shard contributes the
    candidate rows it owns and a sum assembles the gather (exact: every idx
    hits one shard, int32). The per-(query, block) transforms are then
    QUERY-sharded — shard s runs ``trunc_mac_q1_rows`` (K2 on the card) on
    queries s·nq/ndev..(s+1)·nq/ndev — and an all_gather reassembles the
    bundled wire. nq must divide by the mesh size."""
    ndev = mesh.ndev
    idx = torch.as_tensor(idx).long()
    nq = idx.shape[0]
    if nq % ndev:
        raise ValueError(f"nq={nq} not divisible by {ndev} devices")
    nq_l = nq // ndev
    ctq = torch.as_tensor(ctq).to(torch.int32)
    parts = []
    for (gid, dev), b in zip(mesh.local_shards(), base.shards):
        local, owned = _localize(idx.to(dev), gid, base.rows_l)
        parts.append((b[local].to(torch.int32), owned[..., None]))
    rows = _owner_sum(mesh, parts)                       # [nq, npad, d]
    outs = []
    for gid, dev in mesh.local_shards():
        sl = slice(gid * nq_l, (gid + 1) * nq_l)
        core = _mac_service(params, dev).trunc_mac_q1_rows
        outs.append(core(rows[sl].to(dev), ctq[sl].to(dev)))
    return mesh.all_gather(outs)
