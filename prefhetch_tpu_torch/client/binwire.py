"""Client side of the binary tiled wire (utils/wire_bin.py).

The reference client walks ragged JSON candidates with a running offset
(src/client/client_lib.cpp:129-148). On the binary wire the client instead
caches the server's static tile table ONCE (GET /tiletable — index-layout
metadata on par with the centroid download of stage 2) and resolves each
coarse response's candidate ids/validity locally:

    ids   = table_ids[tile_idx]          # [nq, mt, T] gather from cache
    valid = lane < table_sizes[tile_idx]
    dist  = dmin + qdist · dstep         # u16 → f32, selection-grade

Same privacy decomposition as the JSON wire: the server returns every
candidate in the probed lists and never sees the client's selection.

Connections are persistent (http.client keep-alive) — urllib re-dials per
request, which dominates latency at binary-wire speeds.

The port of prefhetch_tpu/client/binwire.py (numpy and the stdlib).
"""

from __future__ import annotations

import http.client
import urllib.parse
from typing import Optional, Tuple

import numpy as np

from prefhetch_tpu_torch.utils import wire_bin


class BinWireClient:
    """One keep-alive connection + the cached tile table."""

    def __init__(self, addr: str, timeout: float = 600.0) -> None:
        u = urllib.parse.urlparse(addr)
        self._host = u.hostname
        self._port = u.port or 80
        self._timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None
        self.tile_sizes: Optional[np.ndarray] = None   # [ntiles+1] i32
        self.tile_ids: Optional[np.ndarray] = None     # [ntiles+1, T] i32

    # -- transport -------------------------------------------------------
    def _request(
        self, method: str, path: str, body: bytes = b"",
        ctype: str = wire_bin.CONTENT_TYPE,
    ) -> bytes:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout
            )
        headers = {"Accept": wire_bin.CONTENT_TYPE}
        if body:
            headers["Content-Type"] = ctype
        try:
            self._conn.request(method, path, body=body or None,
                               headers=headers)
            resp = self._conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, ConnectionError, OSError):
            # stale keep-alive — re-dial once
            self._conn.close()
            self._conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout
            )
            self._conn.request(method, path, body=body or None,
                               headers=headers)
            resp = self._conn.getresponse()
            data = resp.read()
        if resp.status != 200:
            raise RuntimeError(
                f"{method} {path} -> {resp.status}: {data[:200]!r}"
            )
        return data

    @staticmethod
    def _decode(data: bytes, kind: int):
        """Sections of a response of the expected kind; raises otherwise."""
        got, secs = wire_bin.decode(data)
        if got != kind:
            raise ValueError(f"expected a kind {kind} response, got {got}")
        return secs

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    # -- stages ----------------------------------------------------------
    def fetch_centroids(self) -> np.ndarray:
        return self._decode(self._request("GET", "/query"),
                            wire_bin.KIND_CENTROIDS)[0]

    def fetch_tiletable(self) -> None:
        secs = self._decode(self._request("GET", "/tiletable"),
                            wire_bin.KIND_TILETABLE)
        self.tile_sizes = np.asarray(secs[0])
        self.tile_ids = np.asarray(secs[1])

    def coarse_round(
        self,
        queries: np.ndarray,      # [nq, d] f32
        probes: np.ndarray,       # [nq, nprobe] i64
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """POST /coarsesearch (binary) → padded candidate view
        (ids i32 [nq, L], qdist u16 [nq, L], dmin [nq], dstep [nq]) where
        L = mt·T; invalid lanes have qdist == Q16_PAD and id == -1."""
        if self.tile_ids is None:
            self.fetch_tiletable()
        body = wire_bin.encode(
            wire_bin.KIND_COARSE_REQ,
            [np.asarray(queries, np.float32),
             np.asarray(probes, np.int64)],
        )
        secs = self._decode(self._request("POST", "/coarsesearch", body),
                            wire_bin.KIND_COARSE_TILED)
        tile_idx, qdist, dmin, dstep, _counts = secs
        nq, mt = tile_idx.shape
        ids = self.tile_ids[tile_idx].reshape(nq, -1)   # [nq, mt·T]
        return ids, qdist, np.asarray(dmin), np.asarray(dstep)

    def coarse_topk(
        self,
        queries: np.ndarray,
        probes: np.ndarray,
        k: int,
    ) -> np.ndarray:
        """Stage-5 client selection (top-COARSE_PROBE ids per query,
        ascending coarse distance) straight from the u16 wire — u16 order
        IS distance order, so selection runs on the raw wire values."""
        ids, qdist, _, _ = self.coarse_round(queries, probes)
        nq = qdist.shape[0]
        out = np.empty((nq, k), np.int64)
        for i in range(nq):
            part = np.argpartition(qdist[i], k)[:k]
            order = part[np.argsort(qdist[i][part], kind="stable")]
            out[i] = ids[i][order]
        return out

    def coarse_topk_server(
        self,
        queries: np.ndarray,
        probes: np.ndarray,
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Server-select coarse wire: (ids i32 [nq, k] ascending,
        dists f32 [nq, k]). Privacy-equivalent to the reference flow —
        the precise request names the kept set anyway (see
        engine.coarse_search_topk); ~200× smaller response than the
        all-candidates wires. Needs no tile table."""
        body = wire_bin.encode(
            wire_bin.KIND_COARSE_TOPK_REQ,
            [np.asarray(queries, np.float32),
             np.asarray(probes, np.int64),
             np.asarray([k], np.uint32)],
        )
        secs = self._decode(self._request("POST", "/coarsesearch", body),
                            wire_bin.KIND_COARSE_TOPK)
        return np.asarray(secs[0]), np.asarray(secs[1])

    def precise(
        self,
        queries: np.ndarray,      # [nq, d]
        candidates: np.ndarray,   # [nq, cp] i64
    ) -> np.ndarray:
        body = wire_bin.encode(
            wire_bin.KIND_PRECISE_REQ,
            [np.asarray(queries, np.float32),
             np.asarray(candidates, np.int64)],
        )
        secs = self._decode(self._request("POST", "/precisesearch", body),
                            wire_bin.KIND_PRECISE)
        return np.asarray(secs[0])

    def fetch_vectors(self, ids: np.ndarray) -> np.ndarray:
        body = wire_bin.encode(
            wire_bin.KIND_FETCH_REQ, [np.asarray(ids, np.int64)]
        )
        secs = self._decode(
            self._request("POST", "/precise-vector-pir", body),
            wire_bin.KIND_FETCH)
        return np.asarray(secs[0])
