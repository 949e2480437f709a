"""Server-side query engine — the port of prefhetch_tpu/engine/server.py.

(reference: include/server/server_lib.h:12-50, src/server/server_lib.cpp)

Plaintext subset of the JAX ``QueryEngine``:

- index lifecycle: cold build (train + add + save) vs warm load of the
  parameter-encoding npz (init_index, server_lib.cpp:55-99); either package
  reads the other's file;
- raw base vectors resident on the device for the exact re-rank;
- services: retrieve_centroids (GET /query), precise_search, and the fused
  triage round search_fused (POST /search): tiles → union scan with tile
  pruning (kernel K1) → two-level top-COARSE_PROBE → id resolve → exact
  re-rank → final top-k, one chain of device work with one host sync.

What the port drops: the row pinning (``rows_pin``/``_rows_pad``) and the
power-of-two union padding of the JAX engine existed only to pin XLA
program shapes; PyTorch compiles nothing, and the padding made the scan
store PAD blocks for roughly the whole index on every batch. Results do not
change (tests/test_torch_engine.py). The union keeps its 128-bucket and the
empty tile as its last entry.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.data.io import read_fvecs
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.index.build import (
    build_ivf_index, load_index, save_index,
)
from prefhetch_tpu_torch.index.tiling import TILE, TiledView, build_tiled_view
from prefhetch_tpu_torch.index.types import IVFIndex
from prefhetch_tpu_torch.ops.rerank import exact_rerank, final_topk
from prefhetch_tpu_torch.ops.topk import topk_select, topk_select_segmented
from prefhetch_tpu_torch.ops.union_scan import (
    resolve_topk_ids, union_probe_tiles, union_scan_distances,
    union_scan_pruned_fused,
)
from prefhetch_tpu_torch.utils.config import PipelineConfig

logger = logging.getLogger("prefhetch.engine")


class QueryEngine:
    """Holds the index + raw base matrix on one device; serves queries."""

    # Tile size override for the tiled serving layout (None = the
    # index/tiling.py default). Tests use small tiles so tiny fixtures still
    # exercise multi-tile compositions (e.g. segment pruning).
    serve_tile: Optional[int] = None

    def __init__(self, config: PipelineConfig, index_dir: str = ".",
                 device: "str | torch.device" = "cuda"):
        config.validate()
        self.config = config
        self.index_dir = index_dir
        self.device = resolve_device(device)
        self.index: Optional[IVFIndex] = None
        self.base: Optional[torch.Tensor] = None
        self._lock = threading.Lock()
        self._tiled: Optional[TiledView] = None
        self._serve_mt: dict = {}

    # ------------------------------------------------------------------
    def init_index(self) -> None:
        """Cold build or warm load (reference: server_lib.cpp:55-99)."""
        cfg = self.config
        artifact = os.path.join(self.index_dir, cfg.index.artifact_name())

        base = read_fvecs(cfg.base_path)
        if base.shape[1] != cfg.index.d:
            raise ValueError(
                "dataset does not have same dimension as configured d"
            )
        if cfg.index.metric == "cosine":
            from prefhetch_tpu_torch.data.synthetic import normalize_rows

            base = normalize_rows(base)
        if not os.path.exists(artifact):
            logger.info("Loading train set")
            train = read_fvecs(cfg.train_path)
            if train.shape[1] != cfg.index.d:
                raise ValueError(
                    "Incorrect dimensions for train set, not the same as "
                    "PRECISE_VECTOR_DIMENSIONS"
                )
            logger.info("Training on %d vectors", train.shape[0])
            index = build_ivf_index(train, base, cfg.index, self.device)
            path = save_index(index, self.index_dir)
            logger.info("Cached dataset to index file - %s", path)
        else:
            logger.info("Reading cached data from index file - %s", artifact)
            index = load_index(artifact, self.device)
            if index.params != cfg.index:
                raise ValueError("Loaded index params do not match config")
            if index.ntotal != base.shape[0]:
                raise ValueError(
                    f"Loaded index holds {index.ntotal} vectors but "
                    f"the base set has {base.shape[0]}"
                )
        self.set_index(index, base)

    def set_index(self, index: IVFIndex, base: np.ndarray) -> None:
        """In-process injection (tests / embedded use)."""
        if index.device != self.device:
            raise ValueError(
                f"index is on {index.device}, engine on {self.device}"
            )
        self.index = index
        self.base = torch.as_tensor(
            np.asarray(base, np.float32), device=self.device
        )
        self._tiled = None
        self._serve_mt = {}

    @property
    def _tiled_view(self) -> Optional[TiledView]:
        """Tiled scan layout, built once per index (None without a dense
        payload)."""
        if self._tiled is None:
            with self._lock:
                if self._tiled is None:
                    self._tiled = build_tiled_view(
                        self.index, tile=self.serve_tile or TILE
                    )
        return self._tiled

    # -- service 1: GET /query -----------------------------------------
    def retrieve_centroids(self) -> np.ndarray:
        """Export all nlist centroids (reference: server_lib.cpp:101-109)."""
        return self.index.reconstruct_centroids()

    # ------------------------------------------------------------------
    def _tiled_batch_prep(self, probes_np: np.ndarray, q: np.ndarray):
        """Probes → tiles → union, for the tiled scan paths.

        Expands logical probes to the serving tile axis (the worst case over
        any nprobe-probe set, as the JAX engine), dedupes the batch's tiles
        into the union (128-bucket, empty tile last) and uploads what the
        device needs. Returns (tile_idx np [nq, mt], q [nq, d],
        union [U] i32, pos [nq, mt] i32, counts np [nq] i64)."""
        view = self._tiled_view
        nprobe = probes_np.shape[1]
        if nprobe not in self._serve_mt:
            self._serve_mt[nprobe] = view.serving_max_tiles(nprobe)
        tile_idx, counts = view.expand_probes(
            probes_np, min_t=self._serve_mt[nprobe]
        )
        union_np, pos_np = union_probe_tiles(tile_idx, view.empty_tile)
        dev = self.device
        return (
            tile_idx,
            torch.tensor(q, dtype=torch.float32, device=dev),
            torch.from_numpy(union_np.astype(np.int32)).to(dev),
            torch.from_numpy(pos_np).to(dev),
            counts,
        )

    def _serve_prune_j(self, mt: int) -> int:
        """Segment-pruning tile budget for the fused route (0 = off): J=24
        at COARSE_PROBE=256, scaled with the funnel, bounded by the tile
        axis; off when it cannot cover COARSE_PROBE or would not shrink
        anything. PFH_SERVE_PRUNE_J overrides (0 disables)."""
        cp = int(self.config.protocol.coarse_probe)
        T = self._tiled_view.tile
        default_j = 24 * max(1, cp // 256)
        j = int(os.environ.get("PFH_SERVE_PRUNE_J", default_j))
        j = min(j, mt)
        if j <= 0 or j * T < cp or j >= mt:
            return 0
        return j

    # -- service 3: POST /precisesearch ----------------------------------
    def precise_search(
        self,
        precise_query: np.ndarray,             # [nq, d]
        nearest_coarse_vector_idx: np.ndarray,  # [nq, coarse_probe]
    ) -> np.ndarray:
        """Exact L2 of the named candidates (reference:
        server_lib.cpp:140-167)."""
        q = torch.tensor(precise_query, dtype=torch.float32,
                         device=self.device)
        cand = torch.tensor(nearest_coarse_vector_idx, dtype=torch.int64,
                            device=self.device)
        return exact_rerank(self.base, q, cand).cpu().numpy()

    # -- POST /search ------------------------------------------------------
    def search_fused(
        self,
        precise_query: np.ndarray,             # [nq, d]
        nearest_centroid_idx: np.ndarray,      # [nq, nprobe]
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Whole triage round in one request (binary wire kind 11): coarse
        top-COARSE_PROBE → exact re-rank → final top-k. Returns
        (ids i32 [nq, k], dists f32 [nq, k]) ascending; the wire layer
        widens ids to the protocol's i64."""
        return self.search_fused_async(
            precise_query, nearest_centroid_idx, k
        )()

    def search_fused_async(
        self,
        precise_query: np.ndarray,             # [nq, d]
        nearest_centroid_idx: np.ndarray,      # [nq, nprobe]
        k: int,
    ):
        """Enqueue the fused round on the device and return a zero-arg
        resolver; calling it waits for the result and copies it to the
        host. Candidate ids never leave the device between stages."""
        view = self._tiled_view
        if view is None:
            raise ValueError("the fused route needs a dense-payload index")
        cp = max(int(self.config.protocol.coarse_probe), k)
        probes_np = np.asarray(nearest_centroid_idx, np.int64)
        tile_idx, q, union, pos, counts = self._tiled_batch_prep(
            probes_np, np.asarray(precise_query, np.float32)
        )
        if int(counts.min()) < cp:
            raise ValueError(
                f"probed lists hold {int(counts.min())} candidates < "
                f"COARSE_PROBE={cp}"
            )
        mt = tile_idx.shape[1]
        j = self._serve_prune_j(mt)
        tiles = torch.from_numpy(tile_idx).to(self.device)
        if j:
            dist, sel = union_scan_pruned_fused(
                view.payload, view.norms, view.sizes, q, union, pos, j
            )
            _, posk = topk_select_segmented(dist, cp, j, level1_bf16=True)
            tiles = torch.gather(tiles, 1, sel)
        else:
            dist = union_scan_distances(
                view.payload, view.norms, view.sizes, q, union, pos
            )
            _, posk = topk_select(dist, cp)
        cand = resolve_topk_ids(posk, tiles, view.ids)
        scores = exact_rerank(self.base, q, cand)
        ids_k, dists_k = final_topk(scores, cand, k)

        def resolve():
            return ids_k.cpu().numpy(), dists_k.cpu().numpy()

        return resolve
