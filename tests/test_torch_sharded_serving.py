"""The sharded port engine served: counterparts of
tests/test_sharded_serving.py and of
tests/test_batching_and_sharding.py::test_sharded_engine_matches_unsharded.

The port engine, list-sharded over CPU meshes of 1, 2, 4 and 8 shards
(``enable_sharding(devices=["cpu"] * k)``), answers the reference JSON
protocol over the threaded HTTP frontend and the binary routes BYTE for
byte as the unsharded port engine does (the JAX test allows rtol 1e-5 on
JSON distances; the port computes each value by the unsharded arithmetic),
the segment-pruned fused route included, with kernel K1's plain version run
once a shard. A sharded engine never answers through the unsharded
functions, and ``serve.main --shard`` serves the port's client driver."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index.build import build_ivf_index
from prefhetch_tpu.utils.config import IndexParams as JParams
from prefhetch_tpu_torch.engine import server as server_mod
from prefhetch_tpu_torch.engine.server import QueryEngine
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.ops import union_scan_min as usm
from prefhetch_tpu_torch.serve.handlers import Dispatcher
from prefhetch_tpu_torch.serve.http_server import make_server, wrap_batching
from prefhetch_tpu_torch.utils import wire_bin
from prefhetch_tpu_torch.utils.config import (
    IndexParams, PipelineConfig, ProtocolParams,
)

torch.set_num_threads(1)

MESHES = [1, 2, 4, 8]
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")


@pytest.fixture(scope="module")
def setup():
    data = make_clustered_dataset(
        nbase=2048, ntrain=4000, nquery=8, d=32, n_clusters=40, gt_k=50,
        seed=9,
    )
    kw = dict(d=32, nlist=16, pq_m=8, pq_nbits=8, kmeans_iters=8,
              pq_kmeans_iters=8)
    cfg = PipelineConfig(
        index=IndexParams(**kw),
        protocol=ProtocolParams(nprobe=6, coarse_probe=40, k=10, nquery=4),
        nbase=2048,
    )
    j_idx = build_ivf_index(data["train"], data["base"], JParams(**kw))
    arrays = {f: np.asarray(getattr(j_idx, f)) for f in FIELDS
              if getattr(j_idx, f) is not None}
    idx = index_from_numpy(arrays, cfg.index, device="cpu")
    q = data["query"][:4].astype(np.float32)
    cents = arrays["centroids"]
    probes = np.argsort(((q[:, None, :] - cents[None]) ** 2).sum(-1),
                        axis=1)[:, :6]
    return data, cfg, idx, arrays, q, probes


def _engine(setup, k=0, tile=None, arrays=None):
    data, cfg, idx, _, _, _ = setup
    e = QueryEngine(cfg, device="cpu")
    e.serve_tile = tile
    e.set_index(idx if arrays is None
                else index_from_numpy(arrays, cfg.index, device="cpu"),
                data["base"])
    if k:
        e.enable_sharding(devices=["cpu"] * k)
    return e


def _serve(engine):
    srv = make_server(engine, "127.0.0.1", 0)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _post_raw(port, route, payload) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _get_raw(port, route) -> bytes:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{route}", timeout=120
    ) as r:
        return r.read()


@pytest.mark.parametrize("k", MESHES)
def test_sharded_http_responses_byte_identical(setup, k):
    """GET /query and the three JSON POST routes over HTTP."""
    _, _, _, _, q, probes = setup
    s_plain, p_plain = _serve(_engine(setup))
    s_shard, p_shard = _serve(_engine(setup, k))
    try:
        assert _get_raw(p_plain, "/query") == _get_raw(p_shard, "/query")
        coarse_req = {
            "preciseQuery": q.tolist(),
            "nearestCentroidIndexes": probes.tolist(),
        }
        body = _post_raw(p_plain, "/coarsesearch", coarse_req)
        assert body == _post_raw(p_shard, "/coarsesearch", coarse_req)
        cand = np.asarray(json.loads(body)["coarseVectorIndexes"][:40],
                          np.int64)[None].repeat(4, 0)
        precise_req = {
            "preciseQuery": q.tolist(),
            "nearestCoarseVectorIndexes": cand.tolist(),
        }
        assert (_post_raw(p_plain, "/precisesearch", precise_req)
                == _post_raw(p_shard, "/precisesearch", precise_req))
        fetch_req = {"nearestPreciseVectorIndexes": cand[:, :10].tolist()}
        assert (_post_raw(p_plain, "/precise-vector-pir", fetch_req)
                == _post_raw(p_shard, "/precise-vector-pir", fetch_req))
    finally:
        for s in (s_plain, s_shard):
            s.shutdown()
            s.server_close()


@pytest.mark.parametrize("k", MESHES)
def test_sharded_tiled_routes_byte_identical(setup, k):
    """The binary tiled coarse wire, the server-side top-k and the fused
    /search (unpruned at this fixture's tile size) on a k-shard engine:
    equal arrays and equal response bytes."""
    _, _, _, _, q, probes = setup
    plain, sharded = _engine(setup), _engine(setup, k)
    for name, args in (("coarse_search_tiled", (q, probes)),
                       ("coarse_search_topk", (q, probes, 40)),
                       ("search_fused", (q, probes, 10))):
        for a, b in zip(getattr(plain, name)(*args),
                        getattr(sharded, name)(*args)):
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    req = wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
        q, probes.astype(np.int64), np.array([10], np.uint32)])
    hdr = {"content-type": wire_bin.CONTENT_TYPE}
    outs = [Dispatcher(e).handle("POST", "/search", hdr, req)
            for e in (plain, sharded)]
    assert outs[0][0] == 200 and outs[0] == outs[1]


@pytest.mark.parametrize("k", MESHES)
def test_sharded_fused_pruned_byte_identical(setup, monkeypatch, k):
    """The segment-PRUNED fused route (K1 once a shard over its union share,
    the owners' tile minima, the same stable top-J, the kept tiles' rows)
    is byte-identical to the unsharded engine's."""
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    _, _, _, _, q, probes = setup
    plain, sharded = _engine(setup, tile=64), _engine(setup, k, tile=64)
    tiles_np, _ = plain._tiled_view.expand_probes(probes.astype(np.int64))
    assert plain._serve_prune_j(tiles_np.shape[1]) == 4
    want = plain.search_fused(q, probes, 10)
    calls = usm.union_scan_min_reference.calls
    got = sharded.search_fused(q, probes, 10)
    assert usm.union_scan_min_reference.calls - calls == k
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_engine_matches_unsharded(setup, k):
    """coarse_search (JSON, tiled), precise_search and precise_vector_pir of
    a k-shard engine, directly and behind the cross-request batcher."""
    _, _, _, _, q, probes = setup
    plain = _engine(setup)
    cand = np.arange(40)[None].repeat(4, 0)
    ids = np.arange(6)[None].repeat(4, 0)
    for sh in (_engine(setup, k), wrap_batching(_engine(setup, k))):
        for a, b in zip(plain.coarse_search(q, probes),
                        sh.coarse_search(q, probes)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(plain.precise_search(q, cand),
                                      sh.precise_search(q, cand))
        np.testing.assert_array_equal(plain.precise_vector_pir(ids),
                                      sh.precise_vector_pir(ids))


@pytest.mark.parametrize("payload", ["codes", "sq8"])
def test_sharded_dense_list_scan_without_tiled_view(setup, payload):
    """Without a dense payload (PQ codes alone, or an SQ8 index) JSON
    /coarsesearch takes the dense per-list scan: sharded_coarse_scan,
    byte-identical to the unsharded one."""
    data, cfg, _, arrays, q, probes = setup
    if payload == "codes":
        arrays = {f: a for f, a in arrays.items() if f != "list_recon"}
        plain = _engine(setup, arrays=arrays)
        sh = _engine(setup, 4, arrays=arrays)
    else:
        from prefhetch_tpu_torch.index.build import build_ivf_index as tb

        params = IndexParams(d=32, nlist=16, pq_m=0, quantizer="sq8",
                             kmeans_iters=4)
        idx = tb(data["train"], data["base"], params, device="cpu")
        plain = QueryEngine(cfg, device="cpu")
        plain.set_index(idx, data["base"])
        sh = QueryEngine(cfg, device="cpu")
        sh.set_index(idx, data["base"])
        sh.enable_sharding(devices=["cpu"] * 4)
    assert plain._tiled_view is None
    for a, b in zip(plain.coarse_search(q, probes),
                    sh.coarse_search(q, probes)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sharded_engine_never_routes_through_unsharded(setup, monkeypatch):
    """With every unsharded scan, re-rank and fetch of the engine module
    made to raise, every plaintext route of a sharded engine still
    answers: nothing falls back to one device."""
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    _, _, _, _, q, probes = setup
    sh = _engine(setup, 4, tile=64)

    def refuse(*a, **k):
        raise AssertionError("a sharded engine ran an unsharded function")

    for name in ("union_scan_distances", "union_scan_distances_q16",
                 "union_scan_pruned_fused", "exact_rerank", "fetch_vectors",
                 "coarse_scan_flat", "coarse_scan_pq", "coarse_scan_sq8"):
        monkeypatch.setattr(server_mod, name, refuse)
    sh.coarse_search(q, probes)
    sh.coarse_search_tiled(q, probes)
    sh.coarse_search_topk(q, probes, 40)
    sh.search_fused(q, probes, 10)
    sh.precise_search(q, np.arange(40)[None].repeat(4, 0))
    sh.precise_vector_pir(np.arange(6)[None].repeat(4, 0))


def test_enable_sharding_refusals_and_reshard(setup, monkeypatch):
    data, cfg, idx, _, q, probes = setup
    e = QueryEngine(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="before sharding"):
        e.enable_sharding(devices=["cpu"] * 2)
    e.set_index(idx, data["base"])
    with pytest.raises(ValueError, match="nlist=16 not divisible by 3 "
                                         "devices"):
        e.enable_sharding(devices=["cpu"] * 3)
    assert not e.is_sharded
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        e.enable_sharding(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        e.enable_sharding(devices=["cuda:0"])
    e.enable_sharding(devices=["cpu"] * 2)
    assert e.is_sharded and e._mesh.ndev == 2
    # set_index re-shards over the same mesh, and the answers still match
    e.set_index(idx, data["base"])
    assert e._sharded_index.shards[0].list_ids.data_ptr() == \
        idx.list_ids.data_ptr()
    want = _engine(setup).search_fused(q, probes, 10)
    for a, b in zip(want, e.search_fused(q, probes, 10)):
        np.testing.assert_array_equal(a, b)


def test_serve_main_shard_serves_the_driver(tmp_path):
    """``python -m prefhetch_tpu_torch.serve.main --shard --device cpu``
    (a mesh of every visible CPU device: one) answers the port's client
    driver with the recall/MRR block of the same driver against the
    unsharded engine served in-process."""
    import re
    import socket
    import time

    from prefhetch_tpu_torch.data.synthetic import write_sift_style_dataset
    from prefhetch_tpu_torch.serve.http_server import serve_forever
    from prefhetch_tpu_torch.utils.config import PipelineConfig as TCfg

    paths = write_sift_style_dataset(
        str(tmp_path), prefix="shard", nbase=3000, ntrain=4000, nquery=16,
        d=24, n_clusters=24, gt_k=100, seed=31)
    cfg = {
        "index": {"d": 24, "nlist": 12, "pq_m": 6, "pq_nbits": 8,
                  "kmeans_iters": 5, "pq_kmeans_iters": 5},
        "protocol": {"nprobe": 4, "coarse_probe": 120, "k": 100,
                     "nquery": 5},
        "nbase": 3000, "train_path": paths["train"],
        "base_path": paths["base"], "query_path": paths["query"],
        "groundtruth_path": paths["groundtruth"],
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    idx_dir = str(tmp_path / "idx")
    os.makedirs(idx_dir)
    plain = QueryEngine(TCfg.from_json(json.dumps(cfg)), index_dir=idx_dir,
                        device="cpu")
    plain.init_index()                   # the server warm-loads this index
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = subprocess.Popen(
        [sys.executable, "-m", "prefhetch_tpu_torch.serve.main",
         "--config", cfg_path, "--port", str(port), "--index-dir", idx_dir,
         "--frontend", "threaded", "--device", "cpu", "--shard"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=REPO_ROOT)
    inproc = serve_forever(plain, "127.0.0.1", 0, background=True)
    block = re.compile(r"(Recall@1 = [^\n]*)\n[^\n]*(MRR@1 = [^\n]*)")
    try:
        deadline = time.time() + 180
        while True:
            assert srv.poll() is None, srv.stdout.read().decode()[-2000:]
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.3)
        blocks = []
        for p in (port, inproc.server_address[1]):
            cli = subprocess.run(
                [sys.executable, "-m", "prefhetch_tpu_torch.client.driver",
                 "--config", cfg_path, "--server", f"http://127.0.0.1:{p}/"],
                capture_output=True, env=env, cwd=REPO_ROOT, timeout=300)
            out = (cli.stdout + cli.stderr).decode(errors="replace")
            assert cli.returncode == 0, out[-2000:]
            m = block.search(out)
            assert m, out[-2000:]
            blocks.append(m.groups())
        assert blocks[0] == blocks[1]
    finally:
        srv.kill()
        srv.wait(timeout=30)
        srv.stdout.close()
        inproc.shutdown()
        inproc.server_close()
