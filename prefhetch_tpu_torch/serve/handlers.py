"""Transport-agnostic route dispatch — the port of
prefhetch_tpu/serve/handlers.py (plaintext fused-search subset).

A plain (method, path, headers, body) → (status, content-type, bytes)
function, as in the JAX package (reference: src/server/controllers/
Query.cc:10-127). Routes ported so far:

- ``GET /query``   — centroid export, JSON (or binary with
  ``Accept: application/x-prefhetch-bin``)
- ``GET /healthz`` — liveness + index size
- ``GET /stats``   — per-route counters and latencies
- ``POST /search`` — the fused triage round, binary wire only
  (kind 11 request → kind 12 response, utils/wire_bin.py)
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, Tuple

import numpy as np

from prefhetch_tpu_torch.utils import wire_bin

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
    return status, JSON_CT, json.dumps(obj).encode()


def _bin_resp(kind: int, sections, status: int = 200) -> Response:
    return status, BIN_CT, wire_bin.encode(kind, sections)


class Dispatcher:
    """Routes requests to the engine; owns the stats aggregate."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.stats = ServerStats()

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
        self.stats.record(
            f"{method} {path}", time.perf_counter() - t0, resp[0] < 400
        )
        return resp

    def _get(self, path: str, headers: Dict[str, str]) -> Response:
        engine = self.engine
        if path == "/query" or path.rstrip("/") == "":
            # GET /query → bare centroid array (reference: Query.cc:17-23)
            centroids = np.asarray(engine.retrieve_centroids(), np.float32)
            if BIN_CT in headers.get("accept", ""):
                return _bin_resp(wire_bin.KIND_CENTROIDS, [centroids])
            return _json_resp(centroids.tolist())
        if path == "/healthz":
            return _json_resp({"status": "ok", "ntotal": engine.index.ntotal})
        if path == "/stats":
            return _json_resp(self.stats.snapshot())
        return _json_resp({"error": "not found"}, 404)

    def _post(
        self, path: str, headers: Dict[str, str], body: bytes
    ) -> Response:
        if path == "/search":
            if headers.get("content-type", "").startswith(BIN_CT):
                return self._search_bin(body)
            return _json_resp({"error": "binary wire only"}, 400)
        return _json_resp({"error": "not found"}, 404)

    def _check_coarse_args(self, q: np.ndarray, probes: np.ndarray) -> None:
        if q.ndim != 2 or probes.ndim != 2 or q.shape[0] != probes.shape[0]:
            raise ValueError(
                "preciseQuery/nearestCentroidIndexes shape mismatch"
            )
        nlist = self.engine.index.nlist
        if probes.min() < 0 or probes.max() >= nlist:
            raise ValueError("centroid index out of range")

    def _search_bin(self, body: bytes) -> Response:
        """Fused one-round triage (binary wire kind 11 → 12): coarse top-CP
        + exact re-rank + final top-k in one request."""
        kind, secs = wire_bin.decode(body)
        if kind != wire_bin.KIND_SEARCH_REQ or len(secs) != 3:
            raise ValueError("bad search binary request")
        q = np.asarray(secs[0], np.float32)
        probes = np.asarray(secs[1], np.int64)
        k = int(np.asarray(secs[2]).reshape(-1)[0])
        if not 0 < k <= 1 << 20:
            raise ValueError("bad k")
        self._check_coarse_args(q, probes)
        ids, dists = self.engine.search_fused(q, probes, k)
        return _bin_resp(
            wire_bin.KIND_SEARCH,
            [ids.astype(np.int64, copy=False),
             dists.astype(np.float32, copy=False)],
        )
