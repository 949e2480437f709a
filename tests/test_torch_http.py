"""The port's three HTTP frontends over real sockets, each in-process in the
background on a CPU engine: the stdlib threaded server and the asyncio loop
(both with the cross-request batcher) and the native epoll frontend, which
batches waves itself.

Concurrent mixed requests must get the answers the same requests get one
at a time; a wave mixing k values or holding one request its group cannot
take is not poisoned; malformed binary bodies get 400; keep-alive
connections serve many requests; /stats carries the batcher. Every HTTP
call carries a timeout and every server is shut down by its fixture."""

import http.client
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.data.synthetic import write_sift_style_dataset
from prefhetch_tpu_torch.engine.server import QueryEngine
from prefhetch_tpu_torch.utils import wire_bin
from prefhetch_tpu_torch.utils.config import (
    IndexParams, PipelineConfig, ProtocolParams,
)

torch.set_num_threads(1)

D, NPROBE, CP, K = 16, 4, 30, 10
BIN = wire_bin.CONTENT_TYPE


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    ds = tmp_path_factory.mktemp("ds")
    paths = write_sift_style_dataset(
        str(ds), prefix="syn", nbase=2000, ntrain=3000, nquery=16, d=D,
        n_clusters=16, gt_k=50, seed=5,
    )
    cfg = PipelineConfig(
        index=IndexParams(d=D, nlist=8, pq_m=4, pq_nbits=8,
                          kmeans_iters=5, pq_kmeans_iters=5),
        protocol=ProtocolParams(nprobe=NPROBE, coarse_probe=CP, k=K,
                                nquery=4),
        nbase=2000, train_path=paths["train"], base_path=paths["base"],
    )
    e = QueryEngine(cfg, index_dir=str(tmp_path_factory.mktemp("idx")),
                    device="cpu")
    e.serve_tile = 64
    e.init_index()
    return e


@pytest.fixture(scope="module", params=["threaded", "aio", "native"])
def served(request, engine):
    if request.param == "threaded":
        from prefhetch_tpu_torch.serve.http_server import serve_forever

        srv = serve_forever(engine, "127.0.0.1", 0, background=True,
                            batching=True, max_wait_ms=2.0)
        port = srv.server_address[1]
    elif request.param == "aio":
        from prefhetch_tpu_torch.serve.aio_server import serve_forever_aio

        srv = serve_forever_aio(engine, "127.0.0.1", 0, background=True,
                                batching=True, max_wait_ms=2.0)
        port = srv.port
    else:
        from prefhetch_tpu_torch.serve.native_server import (
            serve_forever_native,
        )

        srv = serve_forever_native(engine, port=0, background=True,
                                   grace_ms=1.0)
        port = srv.port
    try:
        yield request.param, engine, port
    finally:
        srv.shutdown()
        if request.param == "threaded":
            srv.server_close()


def _req(port, method, path, body=b"", ctype=None, conn=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    hdrs = {"Accept": BIN} if ctype == BIN else {}
    if body:
        hdrs["Content-Type"] = ctype or "application/json"
    try:
        c.request(method, path, body=body or None, headers=hdrs)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        if conn is None:
            c.close()


def _probes(engine, q, nprobe=NPROBE):
    cent = engine.index.centroids.numpy()
    d2 = ((q[:, None, :] - cent[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :nprobe].astype(np.int64)


def _requests(engine):
    """(name, path, body, content type) of each kind of request, and the
    slab tolerance of their distances."""
    rng = np.random.default_rng(0)
    base = engine.base.numpy()
    out = []
    qsq = 0.0
    for i in range(4):
        q = (base[i * 7: i * 7 + 2] + rng.normal(size=(2, D))).astype(
            np.float32)
        p = _probes(engine, q)
        qsq = max(qsq, float((q.astype(np.float64) ** 2).sum(1).max()))
        cand = rng.integers(0, 2000, (2, CP))
        out += [
            ("json coarse", "/coarsesearch", json.dumps(
                {"preciseQuery": q.tolist(),
                 "nearestCentroidIndexes": p.tolist()}).encode(), None),
            ("json precise", "/precisesearch", json.dumps(
                {"preciseQuery": q.tolist(),
                 "nearestCoarseVectorIndexes": cand.tolist()}).encode(),
             None),
            ("json fetch", "/precise-vector-pir", json.dumps(
                {"nearestPreciseVectorIndexes": cand[:, :K].tolist()}
            ).encode(), None),
            ("search", "/search", wire_bin.encode(
                wire_bin.KIND_SEARCH_REQ, [q[:1], p[:1],
                                           np.array([K], np.uint32)]), BIN),
            ("tiled", "/coarsesearch", wire_bin.encode(
                wire_bin.KIND_COARSE_REQ, [q, p]), BIN),
            ("topk", "/coarsesearch", wire_bin.encode(
                wire_bin.KIND_COARSE_TOPK_REQ, [q, p,
                                                np.array([K], np.uint32)]),
             BIN),
            ("precise", "/precisesearch", wire_bin.encode(
                wire_bin.KIND_PRECISE_REQ, [q, cand]), BIN),
        ]
    xsq = float((base.astype(np.float64) ** 2).sum(1).max())
    return out, 1e-5 * (qsq + xsq)


def _same_answer(name, a, b, tol):
    """Equal up to f32 summation order, which the batch a request joins may
    change: every id, size and PAD lane equal, distances within the slab
    tolerance ``tol`` = 1e-5·(max‖q‖² + max‖x‖²)."""
    if name.startswith("json"):
        ja, jb = json.loads(a), json.loads(b)
        assert ja.keys() == jb.keys()
        for key in ja:
            if key in ("coarseVectorIndexes", "listSizesPerQuery",
                       "queryResults"):
                assert ja[key] == jb[key], (name, key)
            else:
                np.testing.assert_allclose(ja[key], jb[key], rtol=0,
                                           atol=tol, err_msg=name)
        return
    ka, sa = wire_bin.decode(a)
    kb, sb = wire_bin.decode(b)
    assert ka == kb and len(sa) == len(sb)
    for x, y in zip(sa, sb):
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=tol,
                                       err_msg=name)
        elif name == "tiled" and x.dtype == np.uint16:
            pad = x == wire_bin.Q16_PAD
            np.testing.assert_array_equal(pad, y == wire_bin.Q16_PAD)
            assert np.abs(x.astype(int) - y.astype(int))[~pad].max() <= 1
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_concurrent_mixed_requests_equal_single(served):
    _, engine, port = served
    reqs, tol = _requests(engine)
    single = []
    for _, path, body, ct in reqs:
        status, data = _req(port, "POST", path, body, ct)
        assert status == 200, data[:200]
        single.append(data)
    order = list(range(len(reqs))) * 3
    np.random.default_rng(1).shuffle(order)
    with ThreadPoolExecutor(16) as ex:
        outs = list(ex.map(
            lambda i: _req(port, "POST", reqs[i][1], reqs[i][2], reqs[i][3]),
            order))
    for i, (status, data) in zip(order, outs):
        assert status == 200
        _same_answer(reqs[i][0], data, single[i], tol)


def test_mixed_k_and_a_poisoned_group_are_answered(served):
    """Requests of different k in one wave, and requests of one k where
    some probe a list smaller than k: the engine refuses that group, which
    then falls to the Dispatcher one request at a time."""
    _, engine, port = served
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, D)).astype(np.float32) + engine.base[0].numpy()
    p = _probes(engine, q)
    sizes = engine.index.list_sizes.numpy()
    small, big = int(np.argmin(sizes)), int(np.argmax(sizes))
    k_mid = int(sizes[small]) + 1
    assert k_mid <= sizes[big]

    def topk(k, probes):
        return wire_bin.encode(wire_bin.KIND_COARSE_TOPK_REQ, [
            q, probes, np.asarray([k], np.uint32)])

    calls = [(k, p, 200) for k in (5, 10, 5, 10, 7, 5, 10, 7)]
    calls += [(k_mid, np.array([[small]]), 400),
              (k_mid, np.array([[big]]), 200)] * 3
    with ThreadPoolExecutor(len(calls)) as ex:
        outs = list(ex.map(lambda c: _req(port, "POST", "/coarsesearch",
                                          topk(c[0], c[1]), BIN), calls))
    for (k, _, want), (status, data) in zip(calls, outs):
        assert status == want, data[:200]
        if want == 200:
            _, (ids, _, _) = wire_bin.decode(data)
            assert ids.shape == (1, k)


def test_malformed_binary_is_400_and_keepalive_serves_on(served):
    _, engine, port = served
    for path in ("/coarsesearch", "/precisesearch", "/search",
                 "/precise-vector-pir"):
        assert _req(port, "POST", path, b"garbage1", BIN)[0] == 400
    q = np.random.default_rng(5).normal(size=(1, D)).astype(np.float32)
    body = wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
        q, _probes(engine, q), np.asarray([K], np.uint32)])
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        for _ in range(5):
            status, data = _req(port, "POST", "/search", body, BIN, conn=c)
            assert status == 200
            kind, (ids, _) = wire_bin.decode(data)
            assert kind == wire_bin.KIND_SEARCH and ids.shape == (1, K)
        assert _req(port, "GET", "/healthz", conn=c)[0] == 200
        assert _req(port, "GET", "/nope", conn=c)[0] == 404
    finally:
        c.close()


def test_stats_carries_the_batcher(served):
    name, engine, port = served
    q = np.random.default_rng(6).normal(size=(1, D)).astype(np.float32)
    body = json.dumps({"preciseQuery": q.tolist(),
                       "nearestCoarseVectorIndexes": [[1, 2, 3]]}).encode()
    assert _req(port, "POST", "/precisesearch", body)[0] == 200
    status, data = _req(port, "GET", "/stats")
    assert status == 200
    stats = json.loads(data)
    assert stats["frontend"]["name"] == name
    assert stats["POST /precisesearch"]["count"] >= 1
    if name == "native":
        fe = stats["frontend"]
        assert fe["waves"] >= 1 and fe["rows"] >= fe["waves"]
        assert sum(fe["group_calls"].values()) >= 1
        # the JSON request went to the slow pool, which counts its own time
        assert fe["slow_reqs"] >= 1 and fe["slow_serve_s"] > 0
    else:
        assert stats["batcher"]["precise"]["batches"] >= 1
        assert stats["batcher"]["precise"]["rows"] >= 1


def test_client_over_http_equals_client_in_process(served):
    """The port's ClientPipeline over the frontend chooses and scores what
    the same stages do with an in-process Dispatcher for their transport,
    and records each route's response size and wire time."""
    from prefhetch_tpu_torch.client.pipeline import ClientPipeline
    from prefhetch_tpu_torch.serve.handlers import Dispatcher

    _, engine, port = served
    disp = Dispatcher(engine)

    def send(method, route, body):
        status, _, out = disp.handle(method, "/" + route, {}, body)
        assert status == 200, out[:200]
        return out

    rng = np.random.default_rng(9)
    q = (engine.base.numpy()[[3, 700, 1500]]
         + rng.normal(scale=0.5, size=(3, D))).astype(np.float32)

    def stages(c):
        _, order = c.sort_nearest_centroids(q, c.get_centroids())
        cs, ci, sizes = c.get_coarse_scores(order, q)
        return c.get_precise_scores(
            c.compute_nearest_coarse_vectors(cs, ci, sizes), q)

    over_http = ClientPipeline(engine.config, f"http://127.0.0.1:{port}/")
    in_process = ClientPipeline(engine.config, send=send)
    ps, cand = stages(over_http)
    ps_r, cand_r = stages(in_process)
    np.testing.assert_array_equal(cand, cand_r)
    np.testing.assert_array_equal(ps, ps_r)
    routes = {"query", "coarsesearch", "precisesearch"}
    for c in (over_http, in_process):
        assert set(c.bytes) == set(c.wire_ms) == routes
        assert all(c.bytes[r] > 0 and c.wire_ms[r] > 0 for r in routes)
    assert over_http.bytes == in_process.bytes
