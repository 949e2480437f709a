"""Server-side query engine — the port of prefhetch_tpu/engine/server.py.

(reference: include/server/server_lib.h:12-50, src/server/server_lib.cpp)

- index lifecycle: cold build (train + add + save) vs warm load of the
  parameter-encoding npz (init_index, server_lib.cpp:55-99); either package
  reads the other's file; the process-wide instance of the reference's
  singleton (get_instance / reset_instance), which serve/main.py uses;
- raw base vectors resident on the device for the exact re-rank and the
  vector fetch;
- the reference's four services: retrieve_centroids (GET /query),
  coarse_search (POST /coarsesearch, the ragged wire), precise_search
  (POST /precisesearch) and precise_vector_pir (POST /precise-vector-pir);
- the binary wire's services: tile_table (GET /tiletable) and
  coarse_search_tiled (the tiled q16 coarse kind), coarse_search_topk (the
  server-side top-k kind, the unpruned f32 union scan → top-k → id
  resolve), and the fused triage round search_fused (POST /search): tiles →
  union scan with tile pruning (kernel K1) → two-level top-COARSE_PROBE →
  id resolve → exact re-rank → final top-k, one chain of device work with
  one host sync. The serving frontends call the ``*_async`` forms, which
  enqueue the device work and return a resolver;
- encrypted_precise_search (POST /encryptedsearch): Enc(⟨q, x⟩) for the
  candidates the client names. BFV with the "full", "q1" and "packed"
  response wires through engine/hecompute.py; CKKS (BASELINE config 3)
  with the per-block and the "combined" responses through
  engine/ckks_device.py; every transform one launch of kernel K2;
- pir_fetch (POST /pir-fetch): private row retrieval in its four forms,
  the naive and 1-D packed ones through crypto/pir.py ``PIRServer``
  (numpy, as in the JAX engine), the 2-D hypercube and its multi-row form
  through engine/pir_device.py ``DevicePIR2`` on the engine's device.

``enable_sharding`` shards the index over a mesh (parallel/): inverted lists
along nlist, base rows along nbase, the tiled view along its tiles, each
shard a view of the engine's own tensors on its device (a last shard that
the rows do not fill is a zero-padded copy). From then on the
plaintext services route to the sharded functions of parallel/sharded.py
(the tiled scans, the fused route with K1 once a shard, the dense scan, the
re-rank and the fetch) and answer byte for byte as the unsharded engine does.
The encrypted and PIR routes run as on one device, as in the JAX engine; the
sharded forms of their device programs are ``sharded_trunc_mac_q1`` and
``DevicePIR2.answer_2d_sharded``.

The coarse scans of the JSON and tiled wires are plain PyTorch: the JAX
package computes them in XLA, outside its Pallas kernels. coarse_search
takes the tiled branch whenever the index has a tiled view, on every
device (the branch the JAX engine runs on its accelerator and under
``force_tiled``), and the dense scans of ops/scan.py otherwise.

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
from prefhetch_tpu_torch.ops.rerank import (
    exact_rerank, fetch_vectors, final_topk,
)
from prefhetch_tpu_torch.ops.scan import (
    coarse_scan_flat, coarse_scan_pq, coarse_scan_sq8,
)
from prefhetch_tpu_torch.ops.topk import topk_select, topk_select_segmented
from prefhetch_tpu_torch.ops.union_scan import (
    resolve_topk_ids, union_probe_tiles, union_scan_distances,
    union_scan_distances_q16, union_scan_pruned_fused,
)
from prefhetch_tpu_torch.utils.config import PipelineConfig

logger = logging.getLogger("prefhetch.engine")


class QueryEngine:
    """Holds the index + raw base matrix on a device, or sharded over a
    mesh of devices (enable_sharding); serves queries."""

    # Tile size override for the tiled serving layout (None = the
    # index/tiling.py default). Tests use small tiles so tiny fixtures still
    # exercise multi-tile compositions (e.g. segment pruning).
    serve_tile: Optional[int] = None

    _instance: Optional["QueryEngine"] = None
    _instance_lock = threading.Lock()

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
        self._he_service = None
        self._ckks_service = None
        self._pir_service = None
        self._pir2_service = None
        self._mesh = None
        self._sharded_tiled_cache = None

    # Reference singleton accessor (include/server/server_lib.h:20-23).
    @classmethod
    def get_instance(
        cls, config: Optional[PipelineConfig] = None, index_dir: str = ".",
        device: "str | torch.device" = "cuda",
    ) -> "QueryEngine":
        with cls._instance_lock:
            if cls._instance is None:
                if config is None:
                    raise ValueError("the first get_instance needs a config")
                cls._instance = cls(config, index_dir, device=device)
            return cls._instance

    @classmethod
    def reset_instance(cls) -> None:
        """Drop the singleton (test isolation); a handle kept across a reset
        must be re-acquired through get_instance."""
        with cls._instance_lock:
            cls._instance = None

    def enable_sharding(self, n_devices: Optional[int] = None,
                        devices=None) -> None:
        """Shard the index + base matrix over a mesh of the first n visible
        devices of the engine's type (default: all) or of ``devices`` (a
        device may repeat; parallel/mesh.make_mesh): inverted lists along
        nlist, base rows along nbase (zero rows pad the last shard); queries
        replicated. The services below then route to the sharded functions.
        Net-new capability vs the reference (SURVEY §2.4). Call after the
        index is loaded; set_index re-shards over the same mesh."""
        from prefhetch_tpu_torch.parallel.mesh import make_mesh

        if self.index is None:
            raise RuntimeError("load or build the index before sharding it")
        mesh = make_mesh(n_devices, device=self.device, devices=devices)
        if mesh.leader != self.device:
            raise ValueError(f"the mesh's first device {mesh.leader} is not "
                             f"the engine's {self.device}")
        self._shard(mesh)
        logger.info("Sharded index across %d devices (%d lists/device)",
                    mesh.ndev, self.index.nlist // mesh.ndev)

    def _shard(self, mesh) -> None:
        from prefhetch_tpu_torch.parallel.sharded import (
            shard_index, shard_rows,
        )

        sindex = shard_index(self.index, mesh)
        self._base_shards = shard_rows(self.base, mesh, pad=True)
        self._sharded_index = sindex
        self._sharded_tiled_cache = None
        self._mesh = mesh

    @property
    def is_sharded(self) -> bool:
        return self._mesh is not None

    @property
    def _sharded_tiled(self):
        """Tile-sharded twin of the tiled view (lazy, once per index):
        payload, norms and sizes sharded by tile ranges, ids replicated
        (parallel/sharded.shard_tiled_view)."""
        if self._sharded_tiled_cache is None:
            from prefhetch_tpu_torch.parallel.sharded import shard_tiled_view

            view = self._tiled_view
            with self._lock:
                if self._sharded_tiled_cache is None:
                    self._sharded_tiled_cache = shard_tiled_view(
                        view, self._mesh)
        return self._sharded_tiled_cache

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
        self._he_service = None
        self._ckks_service = None
        self._pir_service = None
        self._pir2_service = None
        if self._mesh is not None:
            self._shard(self._mesh)

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
        union [U] i32, pos [nq, mt] i32, counts np [nq] i64). A sharded
        engine splits the union across tile owners on the host instead
        (parallel/sharded.partition_union): union is then union_dev np
        [ndev, u_loc] and pos pos_dev np [nq, mt] into the shard-major
        layout."""
        view = self._tiled_view
        nprobe = probes_np.shape[1]
        if nprobe not in self._serve_mt:
            self._serve_mt[nprobe] = view.serving_max_tiles(nprobe)
        tile_idx, counts = view.expand_probes(
            probes_np, min_t=self._serve_mt[nprobe]
        )
        union_np, pos_np = union_probe_tiles(tile_idx, view.empty_tile)
        dev = self.device
        q = torch.tensor(q, dtype=torch.float32, device=dev)
        if self.is_sharded:
            from prefhetch_tpu_torch.parallel.sharded import partition_union

            union_dev, pos_dev, _ = partition_union(
                union_np, pos_np, view.empty_tile, self._sharded_tiled.tpl,
                self._mesh.ndev)
            return tile_idx, q, union_dev, pos_dev, counts
        return (
            tile_idx,
            q,
            torch.from_numpy(union_np.astype(np.int32)).to(dev),
            torch.from_numpy(pos_np).to(dev),
            counts,
        )

    def _union_scan(self, q, union, pos) -> torch.Tensor:
        """The f32 union scan [nq, mt·T] of ``_tiled_batch_prep``'s batch,
        sharded on a sharded engine."""
        if self.is_sharded:
            from prefhetch_tpu_torch.parallel.sharded import (
                sharded_union_scan,
            )

            return sharded_union_scan(self._mesh, self._sharded_tiled, q,
                                      union, pos)
        v = self._tiled_view
        return union_scan_distances(v.payload, v.norms, v.sizes, q, union,
                                    pos)

    def _union_scan_pruned(self, q, union, pos, j: int):
        """The pruned union scan on K1 → (dist bf16 [nq, j·T], sel [nq, j]),
        K1 once a shard on a sharded engine."""
        if self.is_sharded:
            from prefhetch_tpu_torch.parallel.sharded import (
                sharded_union_scan_pruned,
            )

            return sharded_union_scan_pruned(
                self._mesh, self._sharded_tiled, q, union, pos, j)
        v = self._tiled_view
        return union_scan_pruned_fused(v.payload, v.norms, v.sizes, q,
                                       union, pos, j)

    def _rerank(self, q, cand) -> torch.Tensor:
        """Exact re-rank [nq, P] against the base (row-sharded on a sharded
        engine)."""
        if self.is_sharded:
            from prefhetch_tpu_torch.parallel.sharded import sharded_rerank

            return sharded_rerank(self._mesh, self._base_shards, q, cand)
        return exact_rerank(self.base, q, cand)

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

    # -- binary wire: GET /tiletable, tiled POST /coarsesearch -------------
    def tile_table(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """The static tile→(sizes, global ids) tables a binary-wire client
        caches once (GET /tiletable): (sizes i32 [ntiles+1],
        ids i32 [ntiles+1, T], T). Public information — derived from the
        same index layout the centroid export already reveals."""
        v = self._tiled_view
        if v is None:
            raise ValueError("tiled wire requires a dense-payload index")
        return v.tile_sizes_np, v.tile_ids_np, v.tile

    def coarse_search_tiled(
        self,
        precise_query: np.ndarray,        # [nq, d]
        nearest_centroid_idx: np.ndarray,  # [nq, nprobe]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        return self.coarse_search_tiled_async(
            precise_query, nearest_centroid_idx
        )()

    def coarse_search_tiled_async(
        self,
        precise_query: np.ndarray,        # [nq, d]
        nearest_centroid_idx: np.ndarray,  # [nq, nprobe]
    ):
        """All-candidate coarse scan, tiled binary wire form; enqueues the
        device work and returns a zero-arg resolver.

        Same privacy semantics as coarse_search (EVERY candidate distance in
        the probed lists goes back to the client, which keeps its selection
        to itself, server_lib.cpp:111-138), but the response stays in the
        padded tile layout:

            (tile_idx i32 [nq, mt], qdist u16 [nq, mt·T],
             dmin f32 [nq], dstep f32 [nq], counts i64 [nq])

        The client resolves ids and validity from its cached tile table
        (tile_table), so the server does no per-candidate host work."""
        view = self._tiled_view
        if view is None:
            raise ValueError("tiled wire requires a dense-payload index")
        tile_idx, q, union, pos, counts = self._tiled_batch_prep(
            np.asarray(nearest_centroid_idx, np.int64),
            np.asarray(precise_query, np.float32),
        )
        if self.is_sharded:
            from prefhetch_tpu_torch.parallel.sharded import (
                sharded_union_scan_q16,
            )

            qd, dmin, dstep = sharded_union_scan_q16(
                self._mesh, self._sharded_tiled, q, union, pos)
        else:
            qd, dmin, dstep = union_scan_distances_q16(
                view.payload, view.norms, view.sizes, q, union, pos
            )

        def resolve():
            return (tile_idx, qd.cpu().numpy(), dmin.cpu().numpy(),
                    dstep.cpu().numpy(), counts)

        return resolve

    # -- service 2: POST /coarsesearch ----------------------------------
    def coarse_search(
        self,
        precise_query: np.ndarray,        # [nq, d]
        nearest_centroid_idx: np.ndarray,  # [nq, nprobe]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All-candidate coarse scan of the client-chosen inverted lists.

        Returns the reference's ragged wire layout
        (server_lib.cpp:111-138): candidates concatenated query-after-query
        (probe order, storage order within a list), as
        (coarse_distance_scores [Σsizes] f32,
         coarse_vector_indexes [Σsizes] i64,
         list_sizes_per_query [nq] i64).

        With a tiled view (any dense payload) the logical probes expand to
        tiles, the f32 union scan scores them and ids and validity resolve
        on the host from the static tile tables; without one, the dense
        scans of ops/scan.py run over the padded lists, in the JAX engine's
        order."""
        view = self._tiled_view
        if view is not None:
            tile_idx, q, union, pos, counts = self._tiled_batch_prep(
                np.asarray(nearest_centroid_idx, np.int64),
                np.asarray(precise_query, np.float32),
            )
            dist = self._union_scan(q, union, pos).cpu().numpy()
            lane = np.arange(view.tile)
            tsz = view.tile_sizes_np[tile_idx]               # [nq, mt]
            mask = (lane[None, None, :] < tsz[:, :, None]).reshape(-1)
            scores = dist.reshape(-1)[mask].astype(np.float32)
            ids = view.tile_ids_np[tile_idx].reshape(-1)[mask]
            return scores, ids.astype(np.int64), counts
        idx = self.index
        q = torch.tensor(precise_query, dtype=torch.float32,
                         device=self.device)
        p = torch.tensor(nearest_centroid_idx, dtype=torch.int64,
                         device=self.device)
        if self.is_sharded:
            from prefhetch_tpu_torch.parallel.sharded import (
                sharded_coarse_scan,
            )

            res = sharded_coarse_scan(self._mesh, self._sharded_index, q, p)
        elif idx.list_sq is not None:
            res = coarse_scan_sq8(
                idx.list_sq, idx.sq_vmin, idx.sq_scale,
                idx.list_ids, idx.list_sizes, q, p,
            )
        elif idx.uses_pq and idx.list_recon is not None:
            res = coarse_scan_flat(
                idx.list_recon, idx.list_ids, idx.list_sizes, q, p,
                idx.list_norms,
            )
        elif idx.uses_pq:
            res = coarse_scan_pq(
                idx.centroids, idx.list_codes, idx.list_ids, idx.list_sizes,
                idx.codebooks, q, p, by_residual=idx.params.by_residual,
            )
        else:
            res = coarse_scan_flat(
                idx.list_vectors, idx.list_ids, idx.list_sizes, q, p,
                idx.list_norms,
            )
        # padded → ragged at the host/wire boundary
        mask = res.mask.cpu().numpy().reshape(-1)
        scores = res.distances.cpu().numpy().reshape(-1)[mask]
        ids = res.ids.cpu().numpy().reshape(-1)[mask]
        return (scores.astype(np.float32), ids.astype(np.int64),
                res.counts.cpu().numpy().astype(np.int64))

    # -- service 3: POST /precisesearch ----------------------------------
    def precise_search(
        self,
        precise_query: np.ndarray,             # [nq, d]
        nearest_coarse_vector_idx: np.ndarray,  # [nq, coarse_probe]
    ) -> np.ndarray:
        """Exact L2 of the named candidates (reference:
        server_lib.cpp:140-167)."""
        return self.precise_search_async(
            precise_query, nearest_coarse_vector_idx
        )()

    def precise_search_async(
        self,
        precise_query: np.ndarray,             # [nq, d]
        nearest_coarse_vector_idx: np.ndarray,  # [nq, coarse_probe]
    ):
        """Enqueue-only form of precise_search; the resolver waits for the
        scores [nq, coarse_probe] f32 and copies them to the host."""
        q = torch.tensor(precise_query, dtype=torch.float32,
                         device=self.device)
        cand = torch.tensor(nearest_coarse_vector_idx, dtype=torch.int64,
                            device=self.device)
        scores = self._rerank(q, cand)
        return lambda: scores.cpu().numpy()

    # -- service 4b: POST /pir-fetch (real PIR) ----------------------------
    @property
    def pir_service(self):
        """Real single-server PIR (crypto/pir.py ``PIRServer``, numpy, as in
        the JAX engine) over the base matrix: the naive and 1-D packed
        forms."""
        if self._pir_service is None:
            from prefhetch_tpu_torch.crypto.params import pir_params_for
            from prefhetch_tpu_torch.crypto.pir import PIRServer

            he = self.config.he
            with self._lock:
                if self._pir_service is None:
                    self._pir_service = PIRServer(
                        self.base.cpu().numpy(),
                        pir_params_for(he.n, he.pir_plain_modulus, he.n_limbs),
                    )
        return self._pir_service

    @property
    def pir2_service(self):
        """2-D hypercube PIR (SealPIR-style): ``DevicePIR2`` on the engine's
        device, the CPU included (K2's plain version there). The JAX engine
        picks its numpy ``PIR2Server`` off the TPU (``PFH_PIR_BACKEND``);
        the port has one service."""
        if self._pir2_service is None:
            from prefhetch_tpu_torch.crypto.params import pir_params_for
            from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

            he = self.config.he
            with self._lock:
                if self._pir2_service is None:
                    self._pir2_service = DevicePIR2(
                        self.base.cpu().numpy(),
                        pir_params_for(he.n, he.pir_plain_modulus, he.n_limbs),
                        device=self.device,
                    )
        return self._pir2_service

    def pir_fetch(
        self,
        pir_queries: list | None = None,
        packed: list | None = None,
        hypercube: list | None = None,
        hypercube_multi: list | None = None,
        key_id: str | None = None,
        galois_keys: dict | None = None,
    ) -> list:
        """Answer PIR queries; the server never learns the row indices.

        Four forms: ``pir_queries`` = naive (G selector cts a row);
        ``packed`` = 1-D oblivious expansion (ONE ct a row, host);
        ``hypercube`` = 2-D SealPIR-style (ONE ct a row, on the device);
        ``hypercube_multi`` = 2-D with multi-row packed queries (ONE ct per
        ⌊N/m⌋ rows; each entry {"ct": wire, "nRows": k} yields k responses
        in order)."""
        from prefhetch_tpu_torch.utils.stages import stage

        if hypercube_multi is not None or hypercube is not None:
            svc = self.pir2_service
            if galois_keys:
                with stage("register galois keys"):
                    svc.register_galois_keys(key_id, galois_keys)
            if not svc.has_keys(key_id):
                raise ValueError(
                    "unknown PIR keyId — register Galois keys first"
                )
            if hypercube is not None and hypercube_multi is None:
                # every selector set of the request folds against one pass
                # over the packed database a chunk
                return svc.answer_2d_batch(hypercube, key_id)
            out: list = []
            # runs of equal nRows (the client pads every chunk to one nRows,
            # so a whole request is usually ONE batched call)
            i = 0
            while i < len(hypercube_multi):
                nr = int(hypercube_multi[i]["nRows"])
                j = i
                while (j < len(hypercube_multi)
                       and int(hypercube_multi[j]["nRows"]) == nr):
                    j += 1
                wires = [e["ct"] for e in hypercube_multi[i:j]]
                out.extend(svc.answer_2d_multi_batch(wires, key_id, nr))
                i = j
            return out
        svc = self.pir_service
        if packed is not None:
            if galois_keys:
                svc.register_galois_keys(key_id, galois_keys)
            if not svc.has_keys(key_id):
                raise ValueError(
                    "unknown PIR keyId — register Galois keys first"
                )
            return [svc.answer_packed(w, key_id) for w in packed]
        return [svc.answer(q) for q in pir_queries]

    # -- service 4: POST /precise-vector-pir ------------------------------
    def precise_vector_pir(self, ids: np.ndarray) -> np.ndarray:
        """Gather the K named vectors per query (reference:
        server_lib.cpp:169-196 — a PIR placeholder: ids arrive in cleartext
        at this protocol revision)."""
        t = torch.tensor(ids, dtype=torch.int64, device=self.device)
        if self.is_sharded:
            from prefhetch_tpu_torch.parallel.sharded import sharded_fetch

            return sharded_fetch(self._mesh, self._base_shards,
                                 t).cpu().numpy()
        return fetch_vectors(self.base, t).cpu().numpy()

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
            dist, sel = self._union_scan_pruned(q, union, pos, j)
            _, posk = topk_select_segmented(dist, cp, j, level1_bf16=True)
            tiles = torch.gather(tiles, 1, sel)
        else:
            dist = self._union_scan(q, union, pos)
            _, posk = topk_select(dist, cp)
        cand = resolve_topk_ids(posk, tiles, view.ids)
        ids_k, dists_k = final_topk(self._rerank(q, cand), cand, k)

        def resolve():
            return ids_k.cpu().numpy(), dists_k.cpu().numpy()

        return resolve

    # -- POST /coarsesearch, binary top-k kind ------------------------------
    def coarse_search_topk(
        self,
        precise_query: np.ndarray,        # [nq, d]
        nearest_centroid_idx: np.ndarray,  # [nq, nprobe]
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.coarse_search_topk_async(
            precise_query, nearest_centroid_idx, k
        )()

    def coarse_search_topk_async(
        self,
        precise_query: np.ndarray,        # [nq, d]
        nearest_centroid_idx: np.ndarray,  # [nq, nprobe]
        k: int,
    ):
        """Server-side top-k coarse selection (binary wire opt-in); enqueues
        the device work and returns a zero-arg resolver.

        Returns (ids i32 [nq, k] ascending by coarse distance,
        dists f32 [nq, k], counts i64 [nq]).

        Privacy: EQUIVALENT to the reference protocol in effect — the
        reference client names its kept top-COARSE_PROBE candidates in
        cleartext in the very next request (/precisesearch,
        src/client/client_lib.cpp:158-187), so the server learns the
        selection one round-trip later regardless; selecting server-side
        reveals nothing extra while shrinking the response ~200×."""
        view = self._tiled_view
        if view is None:
            raise ValueError("tiled wire requires a dense-payload index")
        probes_np = np.asarray(nearest_centroid_idx, np.int64)
        tile_idx, q, union, pos, counts = self._tiled_batch_prep(
            probes_np, np.asarray(precise_query, np.float32)
        )
        if int(counts.min()) < k:
            raise ValueError(
                f"probed lists hold {int(counts.min())} candidates < k={k}"
            )
        vals, posk = topk_select(self._union_scan(q, union, pos), k)
        tiles = torch.from_numpy(tile_idx).to(self.device)
        ids = resolve_topk_ids(posk, tiles, view.ids)

        def resolve():
            return ids.cpu().numpy(), vals.cpu().numpy(), counts

        return resolve

    # -- POST /encryptedsearch ----------------------------------------------
    @property
    def he_service(self):
        """Lazily-built BFV homomorphic compute service (no secret keys
        held), on the engine's device, with the integer base matrix parked
        there. Its parameters are the client's: ODD t under
        resp_mod="packed", as the JAX engine builds them."""
        if self._he_service is None:
            from prefhetch_tpu_torch.crypto.params import bfv_params_for
            from prefhetch_tpu_torch.engine.hecompute import HEComputeService

            he = self.config.he
            with self._lock:
                if self._he_service is None:
                    svc = HEComputeService(
                        bfv_params_for(he.n, he.t_bits, he.n_limbs,
                                       odd_t=he.resp_mod == "packed"),
                        device=self.device,
                    )
                    svc.set_base(self.base)
                    self._he_service = svc
        return self._he_service

    @he_service.setter
    def he_service(self, svc) -> None:
        """Serve with ``svc``, a service built (and warmed) elsewhere over
        this engine's base and parameters."""
        with self._lock:
            self._he_service = svc

    @property
    def ckks_service(self):
        """Lazily-built CKKS slot-packed scoring service (engine/
        ckks_device.py ``DeviceCKKS``, no secret keys held) on the engine's
        device, with the config's CKKS parameters. The JAX engine picks its
        numpy twin off the TPU; the port runs the device program on every
        device (K2's plain version on a CPU tensor)."""
        if self._ckks_service is None:
            from prefhetch_tpu_torch.crypto.params import ckks_params_for
            from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS

            he = self.config.he
            with self._lock:
                if self._ckks_service is None:
                    self._ckks_service = DeviceCKKS(
                        ckks_params_for(he.n, he.scale_bits, he.n_limbs),
                        device=self.device,
                    )
        return self._ckks_service

    def _encrypted_search_ckks(self, encrypted_queries, cand_idx, key_id,
                               galois_keys, resp_mod):
        """The CKKS branch of encrypted_precise_search. "combined": the base
        parked once, the candidates gathered, encoded and scored in one
        device program → {"encryptedScoresCombined", "candidateNorms"};
        any other respMod: the per-block response, the request's queries in
        one program → (per query the block ct wires, per query the norms).
        """
        from prefhetch_tpu_torch.utils.stages import stage

        svc = self.ckks_service
        if galois_keys:
            with stage("register galois keys"):
                svc.register_keys(key_id, galois_keys)
        if not svc.has_keys(key_id):
            raise ValueError("unknown CKKS keyId — register Galois keys first")
        cand = np.asarray(cand_idx, np.int64)
        if resp_mod == "combined":
            if svc._base_dev is None:
                with self._lock, stage("park the base (once)"):
                    if svc._base_dev is None:
                        svc.set_base(self.base)
            res, norms = svc.encrypted_scores_combined_batch(
                encrypted_queries, cand.astype(np.int32), key_id)
            with stage("to_wire (base64)"):
                return {
                    "encryptedScoresCombined": [c.to_wire() for c in res],
                    "candidateNorms": norms.tolist(),
                }
        with stage("ct_from_wire"):
            cts = [svc.ctx.ct_from_wire(w) for w in encrypted_queries]
        with stage("gather (candidate rows)"):
            rows = self.base[torch.from_numpy(cand).to(self.device)]
            rows = rows.cpu().numpy().astype(np.float64)
        res, norms = svc.encrypted_scores_batch(cts, rows, key_id)
        with stage("to_wire (base64)"):
            return ([[c.to_wire() for c in per_q] for per_q in res],
                    norms.tolist())

    def encrypted_precise_search(
        self,
        encrypted_queries: list,                 # [nq] ct wire dicts
        nearest_coarse_vector_idx: np.ndarray,   # [nq, P]
        scheme: str = "bfv",
        key_id: str | None = None,
        galois_keys: dict | None = None,
        resp_mod: str = "full",
    ) -> dict:
        """Encrypted re-rank: Enc(⟨q,x⟩) MACs for the named candidates.

        The plaintext-query precise_search counterpart
        (reference: src/server/server_lib.cpp:140-167), upgraded to the
        encrypted path the reference reserved
        (include/client/client_lib.h:28-36).

        Returns the truncated-response wire dict {"c1Ntt", "c0Ip",
        "candidateNorms"} ("full"), {"c1Q1", "c0Ip", "candidateNorms"}
        ("q1": single-limb modulus-switched wire, ~2× smaller; the client
        must hold a sparse secret) or {"packedScores", "candidateNorms",
        "packGroup"} ("packed": G = packGroup queries per 2-limb response
        ct; needs the client's Galois keys, sent once as ``galois_keys``
        under ``key_id``). CKKS: {"encryptedScoresCombined",
        "candidateNorms"} under resp_mod="combined", otherwise the per-block
        response (ct wires per block per query, norms), as the JAX engine
        returns them; both need the client's Galois keys."""
        from prefhetch_tpu_torch.utils.stages import stage
        from prefhetch_tpu_torch.utils.wire import pack_i32

        if scheme == "ckks":
            return self._encrypted_search_ckks(
                encrypted_queries, nearest_coarse_vector_idx, key_id,
                galois_keys, resp_mod)
        if scheme != "bfv":
            raise ValueError(f"unknown scheme {scheme!r}")
        if resp_mod not in ("full", "q1", "packed"):
            raise ValueError(f"unknown respMod {resp_mod!r}")
        svc = self.he_service
        cand = np.asarray(nearest_coarse_vector_idx, np.int64)
        if resp_mod == "packed":
            if galois_keys:
                with stage("register galois keys"):
                    svc.register_galois_keys(key_id, galois_keys)
            if not svc.has_galois_keys(key_id):
                raise ValueError(
                    "unknown BFV keyId — register Galois keys first")
            # wire-direct: seedTf cts upload only c0 + an 8-byte key (c1
            # regenerates inside the device program)
            packed, norms, grp = svc.encrypted_scores_packed_wire(
                encrypted_queries, cand, key_id)
            with stage("to_wire (base64)"):
                return {
                    "packedScores": [c.to_wire() for c in packed],
                    "candidateNorms": norms.tolist(),
                    "packGroup": grp,
                }
        with stage("ct_from_wire (c1 expansion + host NTT)"):
            cts_in = [svc.ctx.ct_from_wire(w) for w in encrypted_queries]
        if resp_mod == "q1":
            c1_q1, c0_ip, norms = svc.encrypted_scores_trunc_q1(cts_in, cand)
            with stage("pack_i32"):
                return {
                    "c1Q1": pack_i32(c1_q1),
                    "c0Ip": pack_i32(c0_ip),
                    "candidateNorms": norms.tolist(),
                }
        c1_ntt, c0_ip, norms = svc.encrypted_scores_trunc(cts_in, cand)
        with stage("pack_i32"):
            return {
                "c1Ntt": pack_i32(c1_ntt),
                "c0Ip": pack_i32(c0_ip),
                "candidateNorms": norms.tolist(),
            }
