"""Tiled inverted-list view — the port of prefhetch_tpu/index/tiling.py.

Each list is re-packed into ⌈size/T⌉ consecutive tiles of T slots (only a
list's last tile is padded), plus one reserved all-empty tile, always the
last row, that pads probe expansions and union lists. The server expands a
client's logical probes (centroid ids) into tile ids on the host per
request, from a per-list table of tile ids, whole-array; tiles of a list are
consecutive, so candidate order (probe-major, storage order within a list)
is preserved. The re-pack is host numpy, as in
the JAX package, and the tables both have are element-equal to its own.

Three payloads: the dense one (``quant="none"``: bf16 recon or f32
vectors, scanned by K1 or K5), its per-dimension 8-bit quantisation
(``quant="sq8"``, scanned by K4) and the raw PQ codes (``quant="pq"``, M
bytes per vector, scanned by K3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.index.types import IVFIndex

TILE = 512


@dataclasses.dataclass
class TiledView:
    """Device tensors for the tiled scan + host tables for probe expansion."""

    # [ntiles+1, T, d] bf16/f32, or uint8 SQ8 codes, or [ntiles+1, T, M]
    # uint8 PQ codes; +1 = the reserved empty tile
    payload: torch.Tensor
    norms: torch.Tensor         # [ntiles+1, T] f32
    sizes: torch.Tensor         # [ntiles+1] i32 — valid slots per tile
    ids: torch.Tensor           # [ntiles+1, T] i32 — for tail gathers
    tile_ids_np: np.ndarray     # [ntiles+1, T] i32 host — global vector ids
    tile_sizes_np: np.ndarray   # [ntiles+1] i32 host
    tile_start_np: np.ndarray   # [nlist] host — first tile of each list
    tile_count_np: np.ndarray   # [nlist] host — tiles per list
    # [nlist, max tiles a list] i32 host — row c: list c's tile ids in
    # order, padded with the empty tile
    list_tiles_np: np.ndarray
    tile: int = TILE
    # SQ8 payload: x̂ = vmin + (code + ½)·scale per dimension (else None)
    sq_vmin: Optional[torch.Tensor] = None       # [d] f32
    sq_scale: Optional[torch.Tensor] = None      # [d] f32
    # owning inverted list of each tile (empty tile → 0)
    tile_list_np: Optional[np.ndarray] = None    # [ntiles+1] i32

    @property
    def empty_tile(self) -> int:
        return self.payload.shape[0] - 1

    def expand_probes(
        self, probe_ids: np.ndarray, bucket: int = 8,
        min_t: int | None = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Logical probes [nq, nprobe] → (tile ids [nq, max_t],
        candidate counts [nq] — the protocol's listSizesPerQuery).

        max_t is the batch's max tile count rounded up to ``bucket``, at
        least ``min_t``; rows are padded with the empty tile."""
        nq, nprobe = probe_ids.shape
        tcounts = self.tile_count_np[probe_ids]               # [nq, nprobe]
        t_totals = tcounts.sum(axis=1)
        max_t = int(-(-int(t_totals.max()) // bucket) * bucket)
        if min_t is not None:
            max_t = max(max_t, int(min_t))
        out = np.full((nq, max_t), self.empty_tile, np.int32)
        # each probe's row of the list table; its real tiles, in C order
        # (query, probe, storage), fill each query's row from the left
        tiles = self.list_tiles_np[probe_ids]     # [nq, nprobe, max tiles]
        out[np.arange(max_t) < t_totals[:, None]] = (
            tiles[tiles != self.empty_tile])
        cand_counts = self.tile_sizes_np[out].sum(axis=1)
        return out, cand_counts.astype(np.int64)

    def serving_max_tiles(self, nprobe: int, bucket: int = 8) -> int:
        """Tile-axis size covering any nprobe-probe set: the sum of the
        nprobe largest per-list tile counts, bucket-rounded."""
        counts = np.sort(self.tile_count_np)[::-1]
        worst = int(counts[: min(nprobe, len(counts))].sum())
        return int(-(-max(worst, 1) // bucket) * bucket)


def _host(index: IVFIndex, key: str, tensor: Optional[torch.Tensor]):
    """Host copy of an index field: the numpy copy that build_ivf_index or
    load_index kept, else a device fetch (a bf16 tensor as its int16
    bits)."""
    a = index.host_arrays.get(key)
    if a is not None or tensor is None:
        return a
    t = tensor.cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def build_tiled_view(
    index: IVFIndex, tile: int = TILE, quant: str = "none"
) -> Optional[TiledView]:
    """Derive the tiled view from a built index (host-side re-pack), on the
    index's device. Uses the dense scan payload (bf16 recon for PQ, f32
    vectors for flat); returns None if the index has no dense payload.

    quant="sq8": per-dimension affine uint8 payload (x̂ = vmin+(code+½)·s)
    quantised from the dense payload, pad rows included, with
    scale = max(vmax − vmin, 1e-12)/256 and floor (not the index's own SQ8
    quantizer, which rounds against a /255 scale trained on the train set).
    Norms come from the DECODED values, so the scan's distances are exact
    for the quantised payload.

    quant="pq": the payload is the raw PQ codes [·, T, M] uint8 with zero
    norms, for the ADC scan (ops/union_scan.union_pq_scan_distances)."""
    if quant not in ("none", "sq8", "pq"):
        raise ValueError(f"unknown quant {quant!r}")
    bf16 = False
    if quant == "pq":
        if index.list_codes is None:
            return None
        payload_np = _host(index, "codes", index.list_codes)
        payload_np = payload_np.astype(np.uint8, copy=False)
    elif index.list_recon is not None:
        payload_np = _host(index, "payload", index.list_recon)
        bf16 = True
    elif index.list_vectors is not None:
        payload_np = _host(index, "payload", index.list_vectors)
    else:
        return None
    ids_np = _host(index, "ids", index.list_ids)
    sizes_np = _host(index, "sizes", index.list_sizes)
    nlist, lmax, d = payload_np.shape

    def values(a: np.ndarray) -> np.ndarray:
        """f32 values of the dense payload (a bf16 one is held as bits)."""
        if not bf16:
            return a.astype(np.float32, copy=False)
        return (torch.from_numpy(a).view(torch.bfloat16)
                .to(torch.float32).numpy())

    sq_vmin = sq_scale = None
    if quant == "sq8":
        flat = values(payload_np).reshape(-1, d)
        vmin = flat.min(axis=0)
        vmax = flat.max(axis=0)
        scale = np.maximum(vmax - vmin, 1e-12) / 256.0
        codes = np.clip(
            np.floor((flat - vmin[None]) / scale[None]), 0, 255
        ).astype(np.uint8)
        decoded = vmin[None] + (codes.astype(np.float32) + 0.5) * scale[None]
        payload_np = codes.reshape(nlist, lmax, d)
        norms_np = (decoded ** 2).sum(-1).reshape(nlist, lmax)
        sq_vmin, sq_scale = vmin, scale
        bf16 = False
        del flat, codes, decoded
    elif quant == "pq":
        norms_np = np.zeros(payload_np.shape[:2], np.float32)  # ADC needs none
    else:
        norms_np = _host(index, "norms", index.list_norms)
        if norms_np is None:
            norms_np = (values(payload_np) ** 2).sum(-1)

    tile_count = np.maximum(-(-sizes_np // tile), 0)  # ⌈size/T⌉, 0 if empty
    tile_start = np.zeros(nlist, np.int64)
    np.cumsum(tile_count[:-1], out=tile_start[1:])
    ntiles = int(tile_count.sum())
    slot = np.arange(int(tile_count.max(initial=0)))
    list_tiles = np.where(slot < tile_count[:, None],
                          tile_start[:, None] + slot, ntiles).astype(np.int32)

    payload = np.zeros((ntiles + 1, tile, d), payload_np.dtype)
    tile_ids = np.full((ntiles + 1, tile), -1, np.int32)
    tile_sizes = np.zeros(ntiles + 1, np.int32)
    tile_norms = np.zeros((ntiles + 1, tile), np.float32)
    tile_list = np.zeros(ntiles + 1, np.int32)
    for c in range(nlist):
        size = int(sizes_np[c])
        t0 = int(tile_start[c])
        for k in range(int(tile_count[c])):
            lo = k * tile
            hi = min(size, lo + tile)
            n = hi - lo
            payload[t0 + k, :n] = payload_np[c, lo:hi]
            tile_ids[t0 + k, :n] = ids_np[c, lo:hi]
            tile_norms[t0 + k, :n] = norms_np[c, lo:hi]
            tile_sizes[t0 + k] = n
            tile_list[t0 + k] = c

    dev = index.device
    payload_t = torch.from_numpy(payload).to(dev)
    if bf16:
        payload_t = payload_t.view(torch.bfloat16)
    return TiledView(
        payload=payload_t,
        norms=torch.from_numpy(tile_norms).to(dev),
        sizes=torch.from_numpy(tile_sizes).to(dev),
        ids=torch.from_numpy(tile_ids).to(dev),
        tile_ids_np=tile_ids,
        tile_sizes_np=tile_sizes,
        tile_start_np=tile_start.astype(np.int64),
        tile_count_np=tile_count.astype(np.int64),
        list_tiles_np=list_tiles,
        tile=tile,
        sq_vmin=None if sq_vmin is None else torch.from_numpy(sq_vmin).to(dev),
        sq_scale=(None if sq_scale is None
                  else torch.from_numpy(sq_scale).to(dev)),
        tile_list_np=tile_list,
    )
