"""Transport-agnostic route dispatch — the port of
prefhetch_tpu/serve/handlers.py.

A plain (method, path, headers, body) → (status, content-type, bytes)
function, as in the JAX package (reference: src/server/controllers/
Query.cc:10-127), shared by every frontend: the stdlib threaded server
(serve/http_server.py), the asyncio loop (serve/aio_server.py) and the
native epoll frontend (serve/native_server.py). Two wire encodings per
route: JSON with the reference's exact field names, and the binary
container of utils/wire_bin.py (request ``Content-Type`` / ``Accept:
application/x-prefhetch-bin``). Number arrays of the JSON wire are written
by the port's C++ codec (native/json_codec.cpp), byte for byte as the JAX
package writes them.

- ``GET /query``        — centroid export (JSON or binary)
- ``GET /tiletable``    — the binary wire's static tile tables, cached
- ``GET /codebooks``    — public PQ codebooks for the quantized coarse query
- ``GET /healthz``, ``GET /stats`` — liveness; per-route counters, with the
  batcher's and the frontend's snapshots where there are any
- ``POST /coarsesearch`` — JSON: every candidate of the probed lists as the
  reference's ragged wire (``preciseQuery`` or ``coarseQueryCodes``);
  binary: the tiled q16 kind (4 → 2) or the server-side top-k kind (9 → 10)
- ``POST /precisesearch`` — exact distances of the named candidates, JSON or
  binary (5 → 3)
- ``POST /search``      — the fused triage round, binary only (11 → 12)
- ``POST /encryptedsearch`` — the encrypted re-rank, JSON: BFV with
  ``respMod`` "full" (default), "q1" or "packed"; ``scheme="ckks"`` with
  the per-block response (``encryptedScores``) or ``respMod="combined"``
  (``encryptedScoresCombined``)
- ``POST /precise-vector-pir`` — the named vectors, JSON or binary (7 → 8)
- ``POST /pir-fetch``   — private row retrieval, JSON: ``pirHypercubeMulti``,
  ``pirHypercube``, ``pirPacked`` or ``pirQueries`` (selector ciphertexts
  only; the server never sees a row index)
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from prefhetch_tpu_torch import native
from prefhetch_tpu_torch.utils import wire_bin
from prefhetch_tpu_torch.utils.stages import stage

JSON_CT = "application/json"
BIN_CT = wire_bin.CONTENT_TYPE


class ServerStats:
    """Per-route request counters + latency aggregates (GET /stats)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = collections.Counter()
        self._errors = collections.Counter()
        self._total_s = collections.defaultdict(float)
        self._max_s = collections.defaultdict(float)

    def record(self, route: str, seconds: float, ok: bool) -> None:
        with self._lock:
            self._counts[route] += 1
            if not ok:
                self._errors[route] += 1
            self._total_s[route] += seconds
            self._max_s[route] = max(self._max_s[route], seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                route: {
                    "count": self._counts[route],
                    "errors": self._errors[route],
                    "mean_ms": round(
                        self._total_s[route] / self._counts[route] * 1e3, 3
                    ),
                    "max_ms": round(self._max_s[route] * 1e3, 3),
                }
                for route in self._counts
            }


Response = Tuple[int, str, bytes]


def _json_resp(obj, status: int = 200) -> Response:
    with stage("json.dumps"):
        return status, JSON_CT, json.dumps(obj).encode()


def _bin_resp(kind: int, sections, status: int = 200) -> Response:
    return status, BIN_CT, wire_bin.encode(kind, sections)


class Dispatcher:
    """Routes requests to the engine; owns the stats aggregate.

    ``engine`` is a QueryEngine or a serve/batcher.BatchScheduler in front
    of one. ``frontend`` is the serving frontend's snapshot for /stats (its
    name, and for the native frontend its waves)."""

    def __init__(self, engine,
                 frontend: Optional[Callable[[], dict]] = None) -> None:
        self.engine = engine
        self.frontend = frontend
        self.stats = ServerStats()
        self._tiletable: Optional[bytes] = None
        self._cache_lock = threading.Lock()

    def handle(
        self,
        method: str,
        path: str,
        headers: Dict[str, str],
        body: bytes,
    ) -> Response:
        t0 = time.perf_counter()
        try:
            if method == "GET":
                resp = self._get(path, headers)
            elif method == "POST":
                resp = self._post(path, headers, body)
            else:
                resp = _json_resp({"error": "method not allowed"}, 405)
        except (KeyError, TypeError, ValueError, IndexError) as e:
            resp = _json_resp({"error": str(e)}, 400)
        except NotImplementedError as e:
            resp = _json_resp({"error": str(e)}, 501)
        self.stats.record(
            f"{method} {path}", time.perf_counter() - t0, resp[0] < 400
        )
        return resp

    # -- GET routes ------------------------------------------------------
    def _get(self, path: str, headers: Dict[str, str]) -> Response:
        engine = self.engine
        if path == "/query" or path.rstrip("/") == "":
            # GET /query → bare centroid array (reference: Query.cc:17-23)
            centroids = np.asarray(engine.retrieve_centroids(), np.float32)
            if BIN_CT in headers.get("accept", ""):
                return _bin_resp(wire_bin.KIND_CENTROIDS, [centroids])
            return 200, JSON_CT, native.json_encode_f32_nested(centroids)
        if path == "/tiletable":
            # static tile→(size, ids) tables the binary client caches once;
            # always binary (~4 MB at SIFT1M)
            with self._cache_lock:
                if self._tiletable is None:
                    sizes, ids, _ = engine.tile_table()
                    self._tiletable = wire_bin.encode(
                        wire_bin.KIND_TILETABLE,
                        [sizes.astype(np.int32), ids.astype(np.int32)],
                    )
            return 200, BIN_CT, self._tiletable
        if path == "/codebooks":
            # public PQ index metadata, so that an encrypted-mode client can
            # send a quantized coarse query instead of the plaintext one
            idx = engine.index
            if idx.codebooks is None:
                return _json_resp({"codebooks": None})
            return _json_resp({
                "codebooks": idx.codebooks.cpu().numpy().tolist(),
                "byResidual": bool(idx.params.by_residual),
            })
        if path == "/healthz":
            return _json_resp({"status": "ok", "ntotal": engine.index.ntotal})
        if path == "/stats":
            snap = self.stats.snapshot()
            if hasattr(engine, "stats"):   # batching mode
                snap["batcher"] = engine.stats()
            if self.frontend is not None:
                snap["frontend"] = self.frontend()
            return _json_resp(snap)
        return _json_resp({"error": "not found"}, 404)

    # -- POST routes -----------------------------------------------------
    def _post(
        self, path: str, headers: Dict[str, str], body: bytes
    ) -> Response:
        is_bin = headers.get("content-type", "").startswith(BIN_CT)
        if path == "/coarsesearch":
            if is_bin:
                return self._coarse_search_bin(body)
            return self._coarse_search(self._parse_json(body))
        if path == "/precisesearch":
            if is_bin:
                return self._precise_search_bin(body)
            return self._precise_search(self._parse_json(body))
        if path == "/search":
            if is_bin:
                return self._search_bin(body)
            return _json_resp({"error": "binary wire only"}, 400)
        if path == "/encryptedsearch":
            return self._encrypted_search(self._parse_json(body))
        if path == "/precise-vector-pir":
            if is_bin:
                return self._precise_vector_pir_bin(body)
            return self._precise_vector_pir(self._parse_json(body))
        if path == "/pir-fetch":
            return self._pir_fetch(self._parse_json(body))
        return _json_resp({"error": "not found"}, 404)

    @staticmethod
    def _parse_json(body: bytes):
        try:
            with stage("json parse"):
                return json.loads(body)
        except ValueError as e:
            raise ValueError(f"bad json: {e}") from None

    # reference: Query.cc:29-63
    def _coarse_search(self, body) -> Response:
        probes = np.asarray(body["nearestCentroidIndexes"], np.int64)
        if "coarseQueryCodes" in body:
            # encrypted-mode quantized coarse query: PQ codes of
            # (q − centroid[probe₀]) instead of the full-precision query
            # (the reserved compute_encrypted_coarse_query, reference:
            # include/client/client_lib.h:28-36); the exact re-rank then
            # runs encrypted
            codes = np.asarray(body["coarseQueryCodes"], np.int64)
            q = self._reconstruct_coarse_query(codes, probes)
        else:
            q = np.asarray(body["preciseQuery"], np.float32)
        self._check_coarse_args(q, probes)
        scores, indexes, sizes = self.engine.coarse_search(q, probes)
        # Σ list-sizes scores + ids (~10⁴–10⁵ numbers a query at SIFT1M)
        return 200, JSON_CT, (
            b'{"coarseDistanceScores":' + native.json_encode_f32(scores)
            + b',"coarseVectorIndexes":' + native.json_encode_i64(indexes)
            + b',"listSizesPerQuery":' + native.json_encode_i64(sizes) + b"}"
        )

    def _reconstruct_coarse_query(
        self, codes: np.ndarray, probes: np.ndarray
    ) -> np.ndarray:
        idx = self.engine.index
        if idx.codebooks is None:
            raise ValueError("coarseQueryCodes requires a PQ index")
        cb = idx.codebooks.cpu().numpy()       # [M, ksub, dsub]
        M, ksub, dsub = cb.shape
        if codes.ndim != 2 or codes.shape[1] != M:
            raise ValueError("coarseQueryCodes shape mismatch")
        if codes.min() < 0 or codes.max() >= ksub:
            raise ValueError("PQ code out of range")
        rec = cb[np.arange(M)[None, :], codes]         # [nq, M, dsub]
        q = rec.reshape(codes.shape[0], -1)
        if idx.params.by_residual:
            q = q + idx.centroids.cpu().numpy()[probes[:, 0]]
        return q.astype(np.float32)

    def _check_coarse_args(self, q: np.ndarray, probes: np.ndarray) -> None:
        if q.ndim != 2 or probes.ndim != 2 or q.shape[0] != probes.shape[0]:
            raise ValueError(
                "preciseQuery/nearestCentroidIndexes shape mismatch"
            )
        nlist = self.engine.index.nlist
        if probes.min() < 0 or probes.max() >= nlist:
            raise ValueError("centroid index out of range")

    @staticmethod
    def _k(sec) -> int:
        k = int(np.asarray(sec).reshape(-1)[0])
        if not 0 < k <= 1 << 20:
            raise ValueError("bad k")
        return k

    # binary coarse wire, two request kinds:
    # - KIND_COARSE_REQ (q f32 [nq, d], probes i64 [nq, nprobe])
    #   → KIND_COARSE_TILED (tile_idx i32, qdist u16, dmin f32, dstep f32,
    #     counts i64) — ALL candidates, client-side selection
    # - KIND_COARSE_TOPK_REQ (q, probes, k u32 [1])
    #   → KIND_COARSE_TOPK (ids i32 [nq, k], dists f32 [nq, k], counts) —
    #     server-side top-k; privacy-equivalent for the reference flow,
    #     whose next request names the kept set anyway
    #     (engine.coarse_search_topk)
    def _coarse_search_bin(self, body: bytes) -> Response:
        kind, secs = wire_bin.decode(body)
        if kind == wire_bin.KIND_COARSE_REQ and len(secs) == 2:
            q = np.asarray(secs[0], np.float32)
            probes = np.asarray(secs[1], np.int64)
            self._check_coarse_args(q, probes)
            tile_idx, qdist, dmin, dstep, counts = (
                self.engine.coarse_search_tiled(q, probes)
            )
            return _bin_resp(
                wire_bin.KIND_COARSE_TILED,
                [tile_idx.astype(np.int32, copy=False), qdist,
                 dmin.astype(np.float32, copy=False),
                 dstep.astype(np.float32, copy=False),
                 counts.astype(np.int64, copy=False)],
            )
        if kind == wire_bin.KIND_COARSE_TOPK_REQ and len(secs) == 3:
            q = np.asarray(secs[0], np.float32)
            probes = np.asarray(secs[1], np.int64)
            k = self._k(secs[2])
            self._check_coarse_args(q, probes)
            ids, dists, counts = self.engine.coarse_search_topk(q, probes, k)
            return _bin_resp(
                wire_bin.KIND_COARSE_TOPK,
                [ids.astype(np.int32, copy=False),
                 dists.astype(np.float32, copy=False),
                 counts.astype(np.int64, copy=False)],
            )
        raise ValueError("bad coarse binary request")

    def _search_bin(self, body: bytes) -> Response:
        """Fused one-round triage (binary wire kind 11 → 12): coarse top-CP
        + exact re-rank + final top-k in one request."""
        kind, secs = wire_bin.decode(body)
        if kind != wire_bin.KIND_SEARCH_REQ or len(secs) != 3:
            raise ValueError("bad search binary request")
        q = np.asarray(secs[0], np.float32)
        probes = np.asarray(secs[1], np.int64)
        k = self._k(secs[2])
        self._check_coarse_args(q, probes)
        ids, dists = self.engine.search_fused(q, probes, k)
        return _bin_resp(
            wire_bin.KIND_SEARCH,
            [ids.astype(np.int64, copy=False),
             dists.astype(np.float32, copy=False)],
        )

    # reference: Query.cc:65-97
    def _precise_search(self, body) -> Response:
        q = np.asarray(body["preciseQuery"], np.float32)
        cand = np.asarray(body["nearestCoarseVectorIndexes"], np.int64)
        scores = self._precise_scores(q, cand)
        return 200, JSON_CT, (b'{"preciseDistanceScores":'
                              + native.json_encode_f32_nested(scores) + b"}")

    def _precise_search_bin(self, body: bytes) -> Response:
        kind, secs = wire_bin.decode(body)
        if kind != wire_bin.KIND_PRECISE_REQ or len(secs) != 2:
            raise ValueError("bad precise binary request")
        scores = self._precise_scores(np.asarray(secs[0], np.float32),
                                      np.asarray(secs[1], np.int64))
        return _bin_resp(wire_bin.KIND_PRECISE,
                         [np.asarray(scores, np.float32)])

    def _precise_scores(self, q: np.ndarray, cand: np.ndarray) -> np.ndarray:
        if q.ndim != 2 or cand.ndim != 2 or q.shape[0] != cand.shape[0]:
            raise ValueError(
                "preciseQuery/nearestCoarseVectorIndexes shape mismatch"
            )
        self._check_vector_ids(cand)
        return self.engine.precise_search(q, cand)

    def _check_vector_ids(self, ids: np.ndarray) -> None:
        ntotal = self.engine.base.shape[0]
        if ids.min() < 0 or ids.max() >= ntotal:
            raise ValueError("vector index out of range")

    # the encrypted re-rank the reference reserved for SEAL
    # (include/client/client_lib.h:28-36). The query never leaves the
    # client in plaintext on this path.
    def _encrypted_search(self, body) -> Response:
        with stage("shape and range checks"):
            enc_queries = body["encryptedPreciseQuery"]   # [nq] ct wires
            cand = np.asarray(body["nearestCoarseVectorIndexes"], np.int64)
            if cand.ndim != 2 or len(enc_queries) != cand.shape[0]:
                raise ValueError(
                    "encryptedPreciseQuery/nearestCoarseVectorIndexes shape "
                    "mismatch"
                )
            self._check_vector_ids(cand)
        result = self.engine.encrypted_precise_search(
            enc_queries,
            cand,
            scheme=body.get("scheme", "bfv"),
            key_id=body.get("keyId"),
            galois_keys=body.get("galoisKeys"),
            resp_mod=body.get("respMod", "full"),
        )
        if not isinstance(result, dict):
            # CKKS per-block response: result ct wires per block per query
            cts, norms = result
            result = {"encryptedScores": cts, "candidateNorms": norms}
        # json.dumps stays here: the codec writes number arrays without
        # the spaces json.dumps puts after commas, and this response must
        # keep the JAX package's bytes
        return _json_resp(result)

    # reference: Query.cc:99-127
    # net-new route: REAL single-server PIR (crypto/pir.py) — unlike
    # /precise-vector-pir (the reference's cleartext-index placeholder),
    # the request carries only selector ciphertexts.
    def _pir_fetch(self, body) -> Response:
        if "pirHypercubeMulti" in body:
            multi = body["pirHypercubeMulti"]
            if not isinstance(multi, list) or not multi:
                raise ValueError("pirHypercubeMulti must be a non-empty list")
            for entry in multi:
                if not isinstance(entry, dict) or "ct" not in entry \
                        or "nRows" not in entry:
                    raise ValueError(
                        "pirHypercubeMulti entries need 'ct' and 'nRows'"
                    )
            results = self.engine.pir_fetch(
                hypercube_multi=multi,
                key_id=body.get("keyId"),
                galois_keys=body.get("galoisKeys"),
            )
        elif "pirHypercube" in body:
            hyper = body["pirHypercube"]
            if not isinstance(hyper, list) or not hyper:
                raise ValueError("pirHypercube must be a non-empty list")
            results = self.engine.pir_fetch(
                hypercube=hyper,
                key_id=body.get("keyId"),
                galois_keys=body.get("galoisKeys"),
            )
        elif "pirPacked" in body:
            packed = body["pirPacked"]
            if not isinstance(packed, list) or not packed:
                raise ValueError("pirPacked must be a non-empty list")
            results = self.engine.pir_fetch(
                packed=packed,
                key_id=body.get("keyId"),
                galois_keys=body.get("galoisKeys"),
            )
        else:
            queries = body["pirQueries"]
            if not isinstance(queries, list) or not queries:
                raise ValueError("pirQueries must be a non-empty list")
            results = self.engine.pir_fetch(pir_queries=queries)
        return _json_resp({"pirResults": results})

    def _precise_vector_pir(self, body) -> Response:
        ids = np.asarray(body["nearestPreciseVectorIndexes"], np.int64)
        vecs = self._fetch_vectors(ids)
        return 200, JSON_CT, (b'{"queryResults":'
                              + native.json_encode_f32_nested(vecs) + b"}")

    def _precise_vector_pir_bin(self, body: bytes) -> Response:
        kind, secs = wire_bin.decode(body)
        if kind != wire_bin.KIND_FETCH_REQ or len(secs) != 1:
            raise ValueError("bad fetch binary request")
        vecs = self._fetch_vectors(np.asarray(secs[0], np.int64))
        return _bin_resp(wire_bin.KIND_FETCH, [np.asarray(vecs, np.float32)])

    def _fetch_vectors(self, ids: np.ndarray) -> np.ndarray:
        if ids.ndim != 2:
            raise ValueError("nearestPreciseVectorIndexes must be 2-D")
        self._check_vector_ids(ids)
        return self.engine.precise_vector_pir(ids)
