"""Tiled inverted-list view — the port of prefhetch_tpu/index/tiling.py.

Each list is re-packed into ⌈size/T⌉ consecutive tiles of T slots (only a
list's last tile is padded), plus one reserved all-empty tile, always the
last row, that pads probe expansions and union lists. The server expands a
client's logical probes (centroid ids) into tile ids on the host per
request; tiles of a list are consecutive, so candidate order (probe-major,
storage order within a list) is preserved. The re-pack is host numpy, as in
the JAX package, and the tables are element-equal to its own.

Only the dense payload (``quant="none"``: bf16 recon or f32 vectors) is
ported; the SQ8 and PQ-code payloads ship with their scan kernels.
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

    payload: torch.Tensor       # [ntiles+1, T, d] bf16/f32 — +1 = empty tile
    norms: torch.Tensor         # [ntiles+1, T] f32
    sizes: torch.Tensor         # [ntiles+1] i32 — valid slots per tile
    ids: torch.Tensor           # [ntiles+1, T] i32 — for tail gathers
    tile_ids_np: np.ndarray     # [ntiles+1, T] i32 host — global vector ids
    tile_sizes_np: np.ndarray   # [ntiles+1] i32 host
    tile_start_np: np.ndarray   # [nlist] host — first tile of each list
    tile_count_np: np.ndarray   # [nlist] host — tiles per list
    tile: int = TILE
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
        for qi in range(nq):
            pos = 0
            for p in probe_ids[qi]:
                s = self.tile_start_np[p]
                c = self.tile_count_np[p]
                out[qi, pos : pos + c] = np.arange(s, s + c, dtype=np.int32)
                pos += c
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
    vectors for flat); returns None if the index has no dense payload."""
    if quant != "none":
        raise NotImplementedError(f"quant={quant!r} is not ported yet")
    if index.list_recon is not None:
        payload_np = _host(index, "payload", index.list_recon)
        bf16 = True
    elif index.list_vectors is not None:
        payload_np = _host(index, "payload", index.list_vectors)
        bf16 = False
    else:
        return None
    ids_np = _host(index, "ids", index.list_ids)
    sizes_np = _host(index, "sizes", index.list_sizes)
    norms_np = _host(index, "norms", index.list_norms)
    if norms_np is None:
        vals = (torch.from_numpy(payload_np).view(torch.bfloat16)
                .to(torch.float32).numpy() if bf16 else payload_np)
        norms_np = (vals.astype(np.float32) ** 2).sum(-1)
    nlist, lmax, d = payload_np.shape

    tile_count = np.maximum(-(-sizes_np // tile), 0)  # ⌈size/T⌉, 0 if empty
    tile_start = np.zeros(nlist, np.int64)
    np.cumsum(tile_count[:-1], out=tile_start[1:])
    ntiles = int(tile_count.sum())

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
        tile=tile,
        tile_list_np=tile_list,
    )
