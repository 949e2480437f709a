"""Client pipeline library — the port of prefhetch_tpu/client/pipeline.py:
the stages of the triage protocol (reference:
include/client/client_lib.h:15-72, src/client/client_lib.cpp), preserving
the privacy decomposition: ranking and top-k selection always happen HERE,
on the client; the server only computes distances for candidate sets the
client names.

Stages (reference call order, src/client/client.cpp:7-80):
 1. get_query                      — load query vectors from fvecs
 2. get_centroids                  — GET /query
 3. sort_nearest_centroids         — local centroid ranking
 4. get_coarse_scores              — POST /coarsesearch (the plaintext query,
                                     or its PQ codes in encrypted mode)
 5. compute_nearest_coarse_vectors — local ragged unpack + sort
 6. get_precise_scores             — POST /precisesearch, or
    get_encrypted_precise_scores   — POST /encryptedsearch (BFV, the
                                     "full", "q1" and "packed" wires;
                                     CKKS, per-block and "combined")
 7. compute_nearest_precise_vectors— local re-pair + sort
 8. get_precise_vectors_pir        — POST /precise-vector-pir, or
    get_precise_vectors_real_pir   — POST /pir-fetch (pir_mode="he": the
                                     rows leave the server as ciphertexts
                                     it cannot link to an index)
 9. benchmark_results              — recall/MRR scoring (metrics.py)

The client is host numpy and the stdlib's urllib (the reference used
cpr/libcurl blocking calls, src/client/client_lib.cpp:43,109,179,231); the
ragged coarse response is decoded by the port's C++ codec.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import time
import urllib.request
from typing import List, Tuple

import numpy as np

from prefhetch_tpu_torch import native
from prefhetch_tpu_torch.data.io import read_fvecs, read_ivecs
from prefhetch_tpu_torch.metrics import BenchmarkReport, benchmark_results
from prefhetch_tpu_torch.utils.config import PipelineConfig

logger = logging.getLogger("prefhetch.client")


@dataclasses.dataclass
class DistanceIndexData:
    """Parity with the reference's pair struct
    (include/client/client_lib.h:9-12)."""

    distance: float
    idx: int


class ClientPipeline:
    """Drives the multi-round protocol against a server address."""

    def __init__(self, config: PipelineConfig, server_addr: str | None = None,
                 send=None):
        config.validate()
        self.config = config
        # reference hardcodes http://localhost:8080/ (client_lib.h:7)
        self.server_addr = (server_addr or f"http://localhost:{config.port}/").rstrip("/") + "/"
        # the transport: send(method, route, body) -> response bytes; HTTP to
        # server_addr unless the caller passes another (an in-process
        # Dispatcher, for a reference run of the same stages)
        self._send_fn = send or self._http_send
        # per route: the last response's size and its wire time (request
        # sent to response read, ms, host clock)
        self.bytes: dict = {}
        self.wire_ms: dict = {}

    # -- transport ------------------------------------------------------
    # The reference never checks HTTP outcomes — it parses every response
    # unconditionally (SURVEY.md §5.3). Here transient transport failures
    # (connection refused/reset, timeouts) retry with backoff; HTTP error
    # statuses (4xx/5xx) surface immediately as exceptions.
    _RETRIES = 3
    _BACKOFF_S = 0.5

    def _with_retries(self, fn):
        import urllib.error

        last = None
        for attempt in range(self._RETRIES):
            try:
                return fn()
            except urllib.error.HTTPError:
                raise                      # server answered: not transient
            except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
                last = e
                logger.warning(
                    "transport error (attempt %d/%d): %s",
                    attempt + 1, self._RETRIES, e,
                )
                if attempt < self._RETRIES - 1:   # no sleep after last try
                    time.sleep(self._BACKOFF_S * (2 ** attempt))
        raise last

    def _http_send(self, method: str, route: str, body: bytes) -> bytes:
        def go():
            req = urllib.request.Request(
                self.server_addr + route,
                data=body if method == "POST" else None,
                headers=({"Content-Type": "application/json"}
                         if method == "POST" else {}),
                method=method,
            )
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.read()

        return self._with_retries(go)

    def _send(self, method: str, route: str, body: bytes = b"") -> bytes:
        t0 = time.perf_counter()
        out = self._send_fn(method, route, body)
        self.wire_ms[route] = (time.perf_counter() - t0) * 1e3
        self.bytes[route] = len(out)
        return out

    def _get(self, route: str):
        return json.loads(self._send("GET", route))

    def _post(self, route: str, payload: dict):
        return json.loads(self._post_raw(route, payload))

    def _post_raw(self, route: str, payload: dict) -> bytes:
        """POST returning the raw response body (the coarse-search response
        is decoded by the native JSON codec straight from these bytes)."""
        return self._send("POST", route, json.dumps(payload).encode())

    @staticmethod
    def _decode_coarse_response(body: bytes):
        """coarseDistanceScores/coarseVectorIndexes/listSizesPerQuery out of
        the raw /coarsesearch body — native number-array decode (the response
        carries Σ list-sizes ≈ nprobe·nbase/nlist numbers per query, the
        protocol's wire hotspot); a body the codec's field scan cannot
        read (another writer's spacing) is parsed with json."""
        scores = native.json_decode_field(body, "coarseDistanceScores")
        indexes = native.json_decode_field(body, "coarseVectorIndexes")
        sizes = native.json_decode_field(body, "listSizesPerQuery")
        if scores is None or indexes is None or sizes is None:
            resp = json.loads(body)
            return (
                np.asarray(resp["coarseDistanceScores"], np.float32),
                np.asarray(resp["coarseVectorIndexes"], np.int64),
                np.asarray(resp["listSizesPerQuery"], np.int64),
            )
        return (
            scores.astype(np.float32),
            indexes.astype(np.int64),
            sizes.astype(np.int64),
        )

    # -- stage 1 ----------------------------------------------------------
    def get_query(self) -> np.ndarray:
        """Load the first nquery query vectors
        (reference: client_lib.cpp:16-39)."""
        xq = read_fvecs(self.config.query_path)
        d = self.config.index.d
        nq = self.config.protocol.nquery
        if xq.shape[1] != d:
            raise ValueError("query does not have same dimension as train set")
        if xq.shape[0] < nq:
            raise ValueError("NQUERY exceeds number of queries in dataset")
        out = xq[:nq].copy()
        if self.config.index.metric == "cosine":
            from prefhetch_tpu_torch.data.synthetic import normalize_rows

            out = normalize_rows(out)
        return out

    # -- stage 2 ----------------------------------------------------------
    def get_centroids(self) -> np.ndarray:
        """GET /query → [nlist, d] centroids (reference: client_lib.cpp:41-48)."""
        return np.asarray(self._get("query"), np.float32)

    # -- stage 3 ----------------------------------------------------------
    def sort_nearest_centroids(
        self, query: np.ndarray, centroids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Rank ALL centroids per query by squared L2, ascending.

        Returns (distances [nq, nlist], ids [nq, nlist]) fully sorted —
        the reference sorts the full list (client_lib.cpp:50-81) and stage 4
        takes the nprobe prefix.
        """
        d2 = (
            (query[:, None, :].astype(np.float64) - centroids[None, :, :]) ** 2
        ).sum(-1)
        order = np.argsort(d2, axis=1, kind="stable")
        return np.take_along_axis(d2, order, axis=1), order.astype(np.int64)

    # -- stage 4 ----------------------------------------------------------
    def get_coarse_scores(
        self, sorted_centroid_ids: np.ndarray, query: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """POST /coarsesearch with the nprobe nearest centroid ids.

        (reference: client_lib.cpp:83-120. The query still travels in
        plaintext at this protocol revision — "Sending precise query
        temporarily", client_lib.h:34-36; the encrypted path is the
        crypto/ subsystem's /encryptedsearch extension.)
        """
        nprobe = self.config.protocol.nprobe
        if sorted_centroid_ids.shape[1] < nprobe:
            raise RuntimeError("Centroids count is not equal to NPROBE")
        probes = sorted_centroid_ids[:, :nprobe]
        if self.config.protocol.encrypted_rerank:
            codes = self._pq_encode_query(query, probes[:, 0])
            if codes is not None:
                # quantized coarse query: the full-precision query never
                # travels on this route in encrypted mode (the reserved
                # compute_encrypted_coarse_query — client_lib.h:28-36)
                body = self._post_raw(
                    "coarsesearch",
                    {
                        "coarseQueryCodes": codes.tolist(),
                        "nearestCentroidIndexes": probes.tolist(),
                    },
                )
                return self._decode_coarse_response(body)
        body = self._post_raw(
            "coarsesearch",
            {
                "preciseQuery": query.tolist(),
                "nearestCentroidIndexes": probes.tolist(),
            },
        )
        return self._decode_coarse_response(body)

    # -- stage 5 ----------------------------------------------------------
    def compute_nearest_coarse_vectors(
        self,
        coarse_scores: np.ndarray,
        coarse_idx: np.ndarray,
        list_sizes: np.ndarray,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Unpack the ragged candidate stream and sort each query's
        candidates ascending (reference: client_lib.cpp:122-156).

        Returns per-query (sorted distances, sorted ids)."""
        cp = self.config.protocol.coarse_probe
        out = []
        off = 0
        for size in list_sizes:
            size = int(size)
            if size < cp:
                raise RuntimeError(
                    "Number of computed coarse scores is lesser than COARSE_PROBE"
                )
            d = coarse_scores[off : off + size]
            i = coarse_idx[off : off + size]
            order = np.argsort(d, kind="stable")
            out.append((d[order], i[order]))
            off += size
        return out

    # -- stage 6 ----------------------------------------------------------
    def get_precise_scores(
        self,
        sorted_coarse: List[Tuple[np.ndarray, np.ndarray]],
        query: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """POST /precisesearch for the top-COARSE_PROBE candidate ids.

        Returns (precise_scores [nq, cp], candidate ids [nq, cp])
        (reference: client_lib.cpp:158-187)."""
        cp = self.config.protocol.coarse_probe
        cand = np.stack([ids[:cp] for _, ids in sorted_coarse])
        resp = self._post(
            "precisesearch",
            {
                "preciseQuery": query.tolist(),
                "nearestCoarseVectorIndexes": cand.tolist(),
            },
        )
        return np.asarray(resp["preciseDistanceScores"], np.float32), cand

    # -- stage 6 (encrypted variant) ---------------------------------------
    def get_encrypted_precise_scores(
        self,
        sorted_coarse: List[Tuple[np.ndarray, np.ndarray]],
        query: np.ndarray,
        he_client=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """POST /encryptedsearch: the query travels ONLY as a ciphertext;
        the server returns Enc(⟨q,x⟩) + plaintext candidate norms, and the
        distances are assembled locally after decryption (exact under BFV,
        approximate under CKKS). The response wire is the config's
        ``he.resp_mod``: BFV "full", "q1" (single-limb, needs
        ``he.sparse_h``) or "packed" (the extraction Galois keys travel
        once); CKKS per-block or "combined" (the rotation Galois keys, with
        the combine-tree steps for "combined", travel once).

        The realized form of the reference's reserved
        compute_encrypted_precise_query (include/client/client_lib.h:28-30).
        """
        from prefhetch_tpu_torch.utils.wire import unpack_i32

        if he_client is None:
            he_client = self._he_client()
        cp = self.config.protocol.coarse_probe
        cand = np.stack([ids[:cp] for _, ids in sorted_coarse])
        payload = {
            "scheme": he_client.scheme,
            "keyId": he_client.key_id,
            "encryptedPreciseQuery": he_client.encrypt_query_batch(query),
            "nearestCoarseVectorIndexes": cand.tolist(),
        }
        resp_mod = self.config.he.resp_mod
        if resp_mod == "q1":
            payload["respMod"] = "q1"
        combine_blocks = 1
        if resp_mod == "combined" and he_client.scheme == "ckks":
            # combined single-ct CKKS response; the Galois key set carries
            # the −W·2^k combine-tree steps too
            payload["respMod"] = "combined"
            combine_blocks = he_client.combine_blocks(cp, query.shape[1])
        if resp_mod == "packed" and he_client.scheme == "bfv":
            payload["respMod"] = "packed"
            gks = he_client.bfv_extraction_keys_wire(query.shape[1])
        else:
            gks = he_client.galois_keys_wire(query.shape[1], combine_blocks)
        if gks is not None:
            payload["galoisKeys"] = gks
        resp = self._post("encryptedsearch", payload)
        norms = np.asarray(resp["candidateNorms"], np.int64)
        if "packedScores" in resp:
            scores = he_client.decrypt_scores_packed(
                resp["packedScores"], norms, query, int(resp["packGroup"]))
        elif "encryptedScoresCombined" in resp:
            scores = he_client.decrypt_scores_combined(
                resp["encryptedScoresCombined"], norms, query)
        elif "c1Q1" in resp:
            scores = he_client.decrypt_scores_trunc_q1(
                unpack_i32(resp["c1Q1"]), unpack_i32(resp["c0Ip"]), norms,
                query)
        elif "c1Ntt" in resp:
            scores = he_client.decrypt_scores_trunc(
                unpack_i32(resp["c1Ntt"]), unpack_i32(resp["c0Ip"]), norms,
                query)
        else:
            # the CKKS per-block response
            scores = he_client.decrypt_scores_batch(
                resp["encryptedScores"], norms, query)
        return scores, cand

    def _pq_encode_query(
        self, query: np.ndarray, anchor_ids: np.ndarray
    ):
        """PQ-encode (q − centroid[anchor]) with the server's PUBLIC
        codebooks (GET /codebooks) — the quantized coarse query leaks only
        the query's PQ cell (M bytes), like any stored vector. Returns
        None when the index has no PQ codebooks (flat/SQ8)."""
        if not hasattr(self, "_codebooks"):
            meta = self._get("codebooks")
            self._codebooks = (
                None if meta.get("codebooks") is None
                else np.asarray(meta["codebooks"], np.float32)
            )
            self._cb_by_residual = bool(meta.get("byResidual", True))
        cb = self._codebooks
        if cb is None:
            return None
        if not hasattr(self, "_centroids_cache"):
            self._centroids_cache = self.get_centroids()
        M, ksub, dsub = cb.shape
        if self._cb_by_residual:
            r = query - self._centroids_cache[anchor_ids]   # [nq, d]
        else:
            # non-residual PQ: codebooks quantize raw vectors
            r = np.asarray(query, np.float32)
        rs = r.reshape(r.shape[0], M, dsub)
        # argmin over codewords per subspace
        d2 = (
            (rs[:, :, None, :] - cb[None]) ** 2
        ).sum(-1)                                           # [nq, M, ksub]
        return np.argmin(d2, axis=-1).astype(np.int64)

    def _he_client(self):
        from prefhetch_tpu_torch.client.he import HEClient

        if not hasattr(self, "_he"):
            self._he = HEClient(self.config.he)
        return self._he

    # -- stage 7 ----------------------------------------------------------
    def compute_nearest_precise_vectors(
        self, precise_scores: np.ndarray, cand_ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Re-pair exact distances with ids and sort ascending
        (reference: client_lib.cpp:189-208)."""
        order = np.argsort(precise_scores, axis=1, kind="stable")
        return (
            np.take_along_axis(precise_scores, order, axis=1),
            np.take_along_axis(cand_ids, order, axis=1),
        )

    # -- stage 8 ----------------------------------------------------------
    def get_precise_vectors_pir(
        self, sorted_precise_ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """POST /precise-vector-pir for the final top-K ids; returns
        (vectors [nq, K, d], ids [nq, K])
        (reference: client_lib.cpp:210-241)."""
        k = self.config.protocol.k
        if k > self.config.protocol.coarse_probe:
            raise RuntimeError("K greater than COARSE_PROBE")
        top_ids = sorted_precise_ids[:, :k]
        resp = self._post(
            "precise-vector-pir",
            {"nearestPreciseVectorIndexes": top_ids.tolist()},
        )
        return np.asarray(resp["queryResults"], np.float32), top_ids

    # -- stage 8 (real-PIR variant) -----------------------------------------
    def get_precise_vectors_real_pir(
        self, sorted_precise_ids: np.ndarray, wire: str = "multi"
    ) -> Tuple[np.ndarray, np.ndarray]:
        """POST /pir-fetch: private retrieval of the final top-K rows. Each
        uploaded BFV ciphertext carries the hypercube indicators of
        ⌊N/m⌋ rows (``wire="multi"``, crypto/pir.build_query_2d_multi; the
        last chunk padded by repeating its final row, its true count kept
        here) or of one row (``wire="single"``); the server expands them
        obliviously (engine/pir_device.DevicePIR2) and never learns which
        rows were fetched. The public Galois expansion keys go with the
        first request of a client; an HTTP 400 (the server lost them)
        re-registers them and retries once. Upgrades the reference's
        placeholder, which sent indices in cleartext
        (src/server/server_lib.cpp:169-196)."""
        from prefhetch_tpu_torch.client.pir import get_pir_client

        if wire not in ("multi", "single"):
            raise ValueError(f"unknown PIR wire {wire!r}")
        k = self.config.protocol.k
        top_ids = sorted_precise_ids[:, :k]
        client = get_pir_client(self.config)
        nbase = self.config.nbase
        d = self.config.index.d
        k_ct = client.rows_per_ct(nbase, d)
        if k_ct <= 1 or wire == "single":
            return self._pir_fetch_single(top_ids, client, nbase, d)
        all_rows = [int(r) for r in top_ids.reshape(-1)]
        entries, rs, n_valids = [], [], []
        for i in range(0, len(all_rows), k_ct):
            chunk = all_rows[i:i + k_ct]
            n_valid = len(chunk)
            chunk = chunk + [chunk[-1]] * (k_ct - n_valid)
            w, r_offs = client.build_query_2d_multi(chunk, nbase, d)
            # nValid stays on the client: the wire shows only cts × nRows
            entries.append({"ct": w, "nRows": k_ct})
            n_valids.append(n_valid)
            rs.extend(r_offs[:n_valid])
        payload = {"pirHypercubeMulti": entries, "keyId": client.key_id}
        gks = functools.partial(client.galois_keys_wire_2d_multi, nbase, d,
                                k_ct)
        if not getattr(client, "_keys_registered", False):
            payload["galoisKeys"] = gks()
        resp = self._post_pir(payload, gks)
        client._keys_registered = True
        # drop the pad rows' responses of the last chunk
        results = []
        for i, n_valid in enumerate(n_valids):
            results.extend(resp["pirResults"][i * k_ct:i * k_ct + n_valid])
        flat = np.stack([client.decode_response_2d(w, d, rs[i])
                         for i, w in enumerate(results)])
        return flat.reshape(top_ids.shape[0], k, d), top_ids

    def _pir_fetch_single(self, top_ids, client, nbase: int, d: int):
        """The single-row pirHypercube wire: one uploaded ct a fetched row
        (a shallower expansion tree than the multi-row wire)."""
        rows = [int(r) for r in top_ids.reshape(-1)]
        wires, rs = zip(*(client.build_query_2d(r, nbase, d) for r in rows))
        payload = {"pirHypercube": list(wires), "keyId": client.key_id}
        gks = functools.partial(client.galois_keys_wire_2d, nbase, d)
        if not getattr(client, "_keys_registered_single", False):
            payload["galoisKeys"] = gks()
        resp = self._post_pir(payload, gks)
        client._keys_registered_single = True
        flat = np.stack([client.decode_response_2d(w, d, rs[i])
                         for i, w in enumerate(resp["pirResults"])])
        nq, k = top_ids.shape
        return flat.reshape(nq, k, d), top_ids

    def _post_pir(self, payload: dict, gks):
        """POST /pir-fetch; on HTTP 400 without keys in the body (the server
        restarted, or another replica answered) register them and retry
        once."""
        import urllib.error

        try:
            return self._post("pir-fetch", payload)
        except urllib.error.HTTPError as e:
            if e.code != 400 or "galoisKeys" in payload:
                raise
            payload["galoisKeys"] = gks()
            return self._post("pir-fetch", payload)

    # -- stage 9 ----------------------------------------------------------
    def benchmark_results(self, observed_idx: np.ndarray) -> BenchmarkReport:
        """Score against ground truth (reference: client_lib.cpp:243-337)."""
        gt = read_ivecs(self.config.groundtruth_path)
        return benchmark_results(
            observed_idx, gt, k=self.config.protocol.k
        )

    # -- full pipeline ------------------------------------------------------
    def run(self) -> Tuple[np.ndarray, np.ndarray]:
        """Stages 1-8; returns (top-K vectors, top-K ids)."""
        query = self.get_query()
        centroids = self.get_centroids()
        _, sorted_cent = self.sort_nearest_centroids(query, centroids)
        cs, ci, sizes = self.get_coarse_scores(sorted_cent, query)
        sorted_coarse = self.compute_nearest_coarse_vectors(cs, ci, sizes)
        if self.config.protocol.encrypted_rerank:
            ps, cand = self.get_encrypted_precise_scores(sorted_coarse, query)
        else:
            ps, cand = self.get_precise_scores(sorted_coarse, query)
        _, sorted_ids = self.compute_nearest_precise_vectors(ps, cand)
        if self.config.protocol.pir_mode == "he":
            return self.get_precise_vectors_real_pir(sorted_ids)
        return self.get_precise_vectors_pir(sorted_ids)
