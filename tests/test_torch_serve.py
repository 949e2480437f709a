"""Port parity: the routes of the port's Dispatcher (device="cpu") against
the JAX engine on the same index.

The JAX engine runs its tiled coarse branch (``force_tiled``, the branch
its accelerator takes), as the port does on every device. Responses are
held against the JAX engine's arrays and the port's codec, never against
the JAX handlers, which would build the JAX package's own native library.
Integer outputs (ids, sizes, tile tables, fetched vectors) are bit-equal;
coarse scores within the slab tolerance 1e-5·(‖q‖² + max‖x‖²); exact
re-rank scores to rtol 1e-6."""

import json

import numpy as np
import pytest
import torch

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.engine.server import QueryEngine as JEngine
from prefhetch_tpu.index.build import build_ivf_index
from prefhetch_tpu.serve.handlers import Dispatcher as JDispatcher
from prefhetch_tpu.utils import wire_bin as j_wire
from prefhetch_tpu.utils.config import (
    IndexParams, PipelineConfig, ProtocolParams,
)
from prefhetch_tpu_torch import native as t_native
from prefhetch_tpu_torch.engine.server import QueryEngine as TEngine
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.serve.batcher import BatchScheduler
from prefhetch_tpu_torch.serve.handlers import Dispatcher as TDispatcher
from prefhetch_tpu_torch.utils import config as tcfg
from prefhetch_tpu_torch.utils import wire_bin

torch.set_num_threads(1)

FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")
NPROBE, CP, K = 6, 40, 10
BIN = {"content-type": wire_bin.CONTENT_TYPE,
       "accept": wire_bin.CONTENT_TYPE}


@pytest.fixture(scope="module")
def setup():
    data = make_clustered_dataset(
        nbase=2048, ntrain=4000, nquery=8, d=32, n_clusters=40, gt_k=50,
        seed=9,
    )
    cfg = PipelineConfig(
        index=IndexParams(d=32, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=NPROBE, coarse_probe=CP, k=K,
                                nquery=4),
        nbase=2048,
    )
    idx = build_ivf_index(data["train"], data["base"], cfg.index)
    arrays = {f: np.asarray(getattr(idx, f)) for f in FIELDS
              if getattr(idx, f) is not None}
    tc = tcfg.PipelineConfig.from_json(cfg.to_json())
    je = JEngine(cfg)
    je.serve_tile = 64                   # many small tiles a list
    je.force_tiled = True
    je.set_index(idx, data["base"])
    te = TEngine(tc, device="cpu")
    te.serve_tile = 64
    te.set_index(index_from_numpy(arrays, tc.index, device="cpu"),
                 data["base"])
    q = data["query"].astype(np.float32)
    cents = np.asarray(idx.centroids)
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :NPROBE].astype(np.int64)
    return data, cfg, idx, arrays, je, te, TDispatcher(te), q, probes


def _slab_tol(q, base):
    return 1e-5 * (float((q.astype(np.float64) ** 2).sum(1).max())
                   + float((base.astype(np.float64) ** 2).sum(1).max()))


def _post_json(disp, path, obj):
    return disp.handle("POST", path, {}, json.dumps(obj).encode())


def _pq_codes(idx, q, probes):
    """The client's PQ codes of (q − centroid[probe₀])."""
    cb = np.asarray(idx.codebooks)
    M, _, dsub = cb.shape
    r = q - np.asarray(idx.centroids)[probes[:, 0]]
    d2 = ((r.reshape(len(q), M, 1, dsub) - cb[None]) ** 2).sum(-1)
    return np.argmin(d2, axis=-1).astype(np.int64)


@pytest.mark.parametrize("query_kind", ["preciseQuery", "coarseQueryCodes"])
def test_json_coarsesearch_matches_jax(setup, query_kind):
    data, _, idx, _, je, _, td, q, probes = setup
    body = {"nearestCentroidIndexes": probes.tolist()}
    if query_kind == "preciseQuery":
        body["preciseQuery"] = q.tolist()
        q_used = q
    else:
        codes = _pq_codes(idx, q, probes)
        body["coarseQueryCodes"] = codes.tolist()
        cb = np.asarray(idx.codebooks)
        q_used = (cb[np.arange(cb.shape[0])[None, :], codes].reshape(len(q),
                                                                    -1)
                  + np.asarray(idx.centroids)[probes[:, 0]]).astype(
                      np.float32)
    status, ctype, resp = _post_json(td, "/coarsesearch", body)
    assert status == 200 and ctype == "application/json"
    s_j, i_j, z_j = je.coarse_search(q_used, probes)
    out = json.loads(resp)
    np.testing.assert_array_equal(out["listSizesPerQuery"], z_j)
    np.testing.assert_array_equal(out["coarseVectorIndexes"], i_j)
    np.testing.assert_allclose(out["coarseDistanceScores"], s_j, rtol=0,
                               atol=_slab_tol(q_used, data["base"]))
    # the ids and sizes are the bytes the codec writes for the JAX arrays
    tail = resp.split(b',"coarseVectorIndexes":', 1)[1]
    assert tail == (t_native.json_encode_i64(i_j) + b',"listSizesPerQuery":'
                    + t_native.json_encode_i64(z_j) + b"}")


def test_coarsesearch_without_tiled_view_matches_jax(setup):
    """An index without a dense payload (PQ codes only) has no tiled view:
    the port scans with ops/scan.py as the JAX engine does."""
    data, cfg, idx, arrays, _, _, _, q, probes = setup
    tc = tcfg.PipelineConfig.from_json(cfg.to_json())
    te = TEngine(tc, device="cpu")
    no_recon = {k: v for k, v in arrays.items() if k != "list_recon"}
    te.set_index(index_from_numpy(no_recon, tc.index, device="cpu"),
                 data["base"])
    assert te._tiled_view is None
    je = JEngine(cfg)
    je.set_index(idx.replace(list_recon=None), data["base"])
    s_t, i_t, z_t = te.coarse_search(q, probes)
    s_j, i_j, z_j = je.coarse_search(q, probes)
    assert i_t.dtype == np.int64 and z_t.dtype == np.int64
    np.testing.assert_array_equal(z_t, z_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-3)


def test_tiled_coarse_kind_matches_jax(setup):
    data, _, _, _, je, _, td, q, probes = setup
    req = wire_bin.encode(wire_bin.KIND_COARSE_REQ, [q, probes])
    status, ctype, resp = td.handle("POST", "/coarsesearch", BIN, req)
    assert status == 200 and ctype == wire_bin.CONTENT_TYPE
    kind, (tile_idx, qd, dmin, dstep, counts) = wire_bin.decode(resp)
    assert kind == wire_bin.KIND_COARSE_TILED and qd.dtype == np.uint16
    t_j, qd_j, dmin_j, dstep_j, c_j = je.coarse_search_tiled(q, probes)
    np.testing.assert_array_equal(tile_idx, t_j)
    np.testing.assert_array_equal(counts, c_j)
    tol = _slab_tol(q, data["base"])
    np.testing.assert_allclose(dmin, dmin_j, rtol=0, atol=tol)
    np.testing.assert_allclose(dstep, dstep_j, rtol=1e-5)
    pad = qd == wire_bin.Q16_PAD
    np.testing.assert_array_equal(pad, qd_j == wire_bin.Q16_PAD)
    diff = np.abs(qd.astype(np.int64) - qd_j.astype(np.int64))
    assert diff[~pad].max() <= 1
    # the tile table resolves every valid lane to an id of a probed list
    sizes, ids, T = je.tile_table()
    lane = np.arange(T)
    valid = (lane[None, None, :] < sizes[tile_idx][:, :, None]).reshape(
        len(q), -1)
    np.testing.assert_array_equal(valid, ~pad)
    list_ids = np.asarray(je.index.list_ids)
    for r in range(len(q)):
        got = ids[tile_idx[r]].reshape(-1)[valid[r]]
        want = list_ids[probes[r]].reshape(-1)
        assert sorted(got) == sorted(want[want >= 0])


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_precisesearch_matches_jax(setup, wire):
    _, _, _, _, je, _, td, q, _ = setup
    cand = np.random.default_rng(3).integers(0, 2048, (len(q), CP))
    if wire == "json":
        status, _, resp = _post_json(td, "/precisesearch", {
            "preciseQuery": q.tolist(),
            "nearestCoarseVectorIndexes": cand.tolist()})
        scores = np.asarray(json.loads(resp)["preciseDistanceScores"],
                            np.float32)
    else:
        status, _, resp = td.handle("POST", "/precisesearch", BIN,
                                    wire_bin.encode(wire_bin.KIND_PRECISE_REQ,
                                                    [q, cand]))
        kind, (scores,) = wire_bin.decode(resp)
        assert kind == wire_bin.KIND_PRECISE
    assert status == 200
    np.testing.assert_allclose(scores, je.precise_search(q, cand), rtol=1e-6)


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_precise_vector_pir_bit_equal(setup, wire):
    _, _, _, _, je, _, td, _, _ = setup
    ids = np.random.default_rng(4).integers(0, 2048, (5, K))
    if wire == "json":
        status, _, resp = _post_json(td, "/precise-vector-pir", {
            "nearestPreciseVectorIndexes": ids.tolist()})
        vecs = np.asarray(json.loads(resp)["queryResults"], np.float32)
    else:
        status, _, resp = td.handle(
            "POST", "/precise-vector-pir", BIN,
            wire_bin.encode(wire_bin.KIND_FETCH_REQ, [ids]))
        kind, (vecs,) = wire_bin.decode(resp)
        assert kind == wire_bin.KIND_FETCH
    assert status == 200
    np.testing.assert_array_equal(vecs, je.precise_vector_pir(ids))


def test_tiletable_codebooks_and_centroids_same_bytes(setup):
    _, _, idx, _, je, _, td, _, _ = setup
    sizes, ids, _ = je.tile_table()
    status, ctype, resp = td.handle("GET", "/tiletable", {}, b"")
    assert status == 200 and ctype == wire_bin.CONTENT_TYPE
    assert resp == j_wire.encode(j_wire.KIND_TILETABLE, [
        sizes.astype(np.int32), ids.astype(np.int32)])
    assert td.handle("GET", "/tiletable", {}, b"")[2] is resp   # cached
    status, _, resp = td.handle("GET", "/codebooks", {}, b"")
    assert status == 200
    assert json.loads(resp) == {
        "codebooks": np.asarray(idx.codebooks).tolist(),
        "byResidual": bool(idx.params.by_residual)}
    status, _, resp = td.handle("GET", "/query", {}, b"")
    assert resp == t_native.json_encode_f32_nested(np.asarray(idx.centroids))


def _cases(q, probes):
    good_q = q[:2].tolist()
    good_p = probes[:2].tolist()
    junk = b"junk!!!!"
    return [
        ("POST", "/coarsesearch", {}, b"{not json"),
        ("POST", "/coarsesearch", {}, json.dumps(
            {"preciseQuery": good_q}).encode()),
        ("POST", "/coarsesearch", {}, json.dumps(
            {"preciseQuery": good_q,
             "nearestCentroidIndexes": [[99] * NPROBE] * 2}).encode()),
        ("POST", "/coarsesearch", {}, json.dumps(
            {"preciseQuery": good_q,
             "nearestCentroidIndexes": good_p[:1]}).encode()),
        ("POST", "/coarsesearch", {}, json.dumps(
            {"coarseQueryCodes": [[300] * 8] * 2,
             "nearestCentroidIndexes": good_p}).encode()),
        ("POST", "/coarsesearch", {}, json.dumps(
            {"coarseQueryCodes": [[1] * 3] * 2,
             "nearestCentroidIndexes": good_p}).encode()),
        ("POST", "/coarsesearch", BIN, junk),
        ("POST", "/coarsesearch", BIN, wire_bin.encode(
            wire_bin.KIND_PRECISE_REQ, [q[:2], probes[:2]])),
        ("POST", "/coarsesearch", BIN, wire_bin.encode(
            wire_bin.KIND_COARSE_REQ, [q[:2], probes[:1]])),
        ("POST", "/precisesearch", {}, json.dumps(
            {"preciseQuery": good_q,
             "nearestCoarseVectorIndexes": [[5000] * 3] * 2}).encode()),
        ("POST", "/precisesearch", {}, json.dumps(
            {"preciseQuery": good_q,
             "nearestCoarseVectorIndexes": [[-1] * 3] * 2}).encode()),
        ("POST", "/precisesearch", BIN, junk),
        ("POST", "/precise-vector-pir", {}, json.dumps(
            {"nearestPreciseVectorIndexes": [1, 2]}).encode()),
        ("POST", "/precise-vector-pir", BIN, wire_bin.encode(
            wire_bin.KIND_FETCH_REQ, [np.array([[1, 9999]])])),
        ("POST", "/search", {}, b"{}"),
        ("POST", "/search", BIN, wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
            q[:2], probes[:2], np.array([0], np.uint32)])),
        ("POST", "/nope", {}, b"{}"),
        ("GET", "/nope", {}, b""),
        ("PUT", "/coarsesearch", {}, b"{}"),
    ]


def test_malformed_requests_answer_like_jax(setup):
    """Each request is refused before any codec runs, so the JAX
    Dispatcher's status can be read without its native library."""
    _, _, _, _, je, _, td, q, probes = setup
    jd = JDispatcher(je)
    for method, path, h, body in _cases(q, probes):
        want = jd.handle(method, path, h, body)[0]
        assert want >= 400
        assert td.handle(method, path, h, body)[0] == want, (path, body[:60])
    # /pir-fetch is served: malformed bodies are refused with JAX's text
    for body in ({"pirQueries": []}, {"pirHypercube": "x"},
                 {"pirPacked": []}, {"pirHypercubeMulti": [{"ct": {}}]},
                 {"nothing": 1}):
        want = jd.handle("POST", "/pir-fetch", {}, json.dumps(body).encode())
        got = _post_json(td, "/pir-fetch", body)
        assert want[0] == 400 and got[0] == 400, body
        assert json.loads(got[2]) == json.loads(want[2]), body


def test_stats_carries_the_batcher(setup):
    _, _, _, _, _, te, _, q, probes = setup
    sched = BatchScheduler(te, max_batch=16, max_wait_ms=2.0)
    disp = TDispatcher(sched, frontend=lambda: {"name": "test"})
    status, _, _ = _post_json(disp, "/coarsesearch", {
        "preciseQuery": q[:3].tolist(),
        "nearestCentroidIndexes": probes[:3].tolist()})
    assert status == 200
    stats = json.loads(disp.handle("GET", "/stats", {}, b"")[2])
    assert stats["frontend"] == {"name": "test"}
    assert stats["batcher"]["coarse"] == {"batches": 1, "rows": 3}
    assert stats["POST /coarsesearch"]["count"] == 1
