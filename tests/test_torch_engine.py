"""Port parity: QueryEngine.search_fused and the Dispatcher against the JAX
engine on the same index (fixture of tests/test_sharded_serving.py).

The JAX engine's pruned route runs its Pallas kernel in interpret mode (on a
TPU it runs the kernel; on the CPU backend it would take the f32 XLA
formulation instead), so both engines select on the same bf16 distances.
PFH_SERVE_PRUNE_J=4 turns tile pruning on at this small size, so K1's route
runs; j=0 covers the unpruned route. The JAX engine pads batch rows and the
union to pin XLA shapes and the port does not: results must not change."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prefhetch_tpu.data.io import write_fvecs
from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.engine.server import QueryEngine as JEngine
from prefhetch_tpu.index.build import build_ivf_index, load_index as j_load
from prefhetch_tpu.ops.union_scan import union_scan_pruned_fused
from prefhetch_tpu.serve.handlers import Dispatcher as JDispatcher
from prefhetch_tpu.utils import wire_bin
from prefhetch_tpu.utils.config import (
    IndexParams, PipelineConfig, ProtocolParams,
)
from prefhetch_tpu_torch.engine.server import QueryEngine as TEngine
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.serve.handlers import Dispatcher as TDispatcher
from prefhetch_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")


def _t_config(cfg: PipelineConfig) -> tcfg.PipelineConfig:
    return tcfg.PipelineConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def setup():
    data = make_clustered_dataset(
        nbase=2048, ntrain=4000, nquery=8, d=32, n_clusters=40, gt_k=50,
        seed=9,
    )
    cfg = PipelineConfig(
        index=IndexParams(d=32, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=6, coarse_probe=40, k=10, nquery=4),
        nbase=2048,
    )
    idx = build_ivf_index(data["train"], data["base"], cfg.index)
    arrays = {f: np.asarray(getattr(idx, f)) for f in FIELDS
              if getattr(idx, f) is not None}
    t_idx = index_from_numpy(arrays, _t_config(cfg).index, device="cpu")
    cents = np.asarray(idx.centroids)
    q = data["query"].astype(np.float32)
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6]
    return data, cfg, idx, t_idx, q, probes


def _pallas_route(view, q_p, union_np, pos_np, mt, j):
    """The JAX engine's TPU route for the pruned scan, Pallas interpreted."""
    return union_scan_pruned_fused(
        view.payload, view.norms, view.sizes, q_p,
        jnp.asarray(union_np), jnp.asarray(pos_np), j, interpret=True,
    )


def _engines(setup, rows_pin=None):
    data, cfg, idx, t_idx, _, _ = setup
    je = JEngine(cfg)
    je.serve_tile = 64                   # many small tiles → mt > j
    je.rows_pin = rows_pin
    je.set_index(idx, data["base"])
    je._dispatch_union_scan_pruned = _pallas_route
    te = TEngine(_t_config(cfg), device="cpu")
    te.serve_tile = 64
    te.set_index(t_idx, data["base"])
    return je, te


def _assert_same_results(ids_t, d_t, ids_j, d_j):
    """dists rtol 1e-5 (exact re-rank, f32); ids equal wherever the
    distance is not tied with a neighbour in the same row."""
    ids_t, ids_j = np.asarray(ids_t), np.asarray(ids_j)
    assert ids_t.shape == ids_j.shape
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
    d = np.asarray(d_j)
    tied = np.zeros_like(d, bool)
    tied[:, 1:] |= d[:, 1:] == d[:, :-1]
    tied[:, :-1] |= d[:, :-1] == d[:, 1:]
    np.testing.assert_array_equal(ids_t[~tied], ids_j[~tied])
    for r in range(ids_t.shape[0]):
        assert set(ids_t[r]) == set(ids_j[r])


@pytest.mark.parametrize("prune_j", ["4", "0"])
@pytest.mark.parametrize("nq,rows_pin", [(4, None), (5, None), (5, 16)])
def test_search_fused_matches_jax(setup, monkeypatch, prune_j, nq, rows_pin):
    """Pruned (K1) and unpruned routes; nq=5 makes the JAX engine pad rows
    (to 8, or to its pin of 16) while the port pads nothing."""
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", prune_j)
    _, _, _, _, q, probes = setup
    je, te = _engines(setup, rows_pin)
    mt = te._tiled_view.serving_max_tiles(6)
    assert mt == je._tiled_view.serving_max_tiles(6)
    assert te._serve_prune_j(mt) == je._serve_prune_j(mt) == int(prune_j)
    ids_j, d_j = je.search_fused(q[:nq], probes[:nq], 10)
    ids_t, d_t = te.search_fused(q[:nq], probes[:nq], 10)
    assert ids_t.dtype == np.int32 and d_t.dtype == np.float32
    _assert_same_results(ids_t, d_t, ids_j, d_j)


def test_precise_search_matches_jax(setup):
    _, _, _, _, q, _ = setup
    je, te = _engines(setup)
    cand = np.random.default_rng(3).integers(0, 2048, (5, 40))
    np.testing.assert_array_equal(te.precise_search(q[:5], cand),
                                  je.precise_search(q[:5], cand))


def test_dispatcher_search_same_answers(setup, monkeypatch):
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    _, _, _, _, q, probes = setup
    je, te = _engines(setup)
    jd, td = JDispatcher(je), TDispatcher(te)
    # GET /query: the same centroids, JSON and binary
    a, b = td.handle("GET", "/query", {}, b""), jd.handle("GET", "/query",
                                                          {}, b"")
    assert a[0] == b[0] == 200
    np.testing.assert_array_equal(np.asarray(json.loads(a[2]), np.float32),
                                  np.asarray(json.loads(b[2]), np.float32))
    hdr = {"accept": wire_bin.CONTENT_TYPE}
    assert td.handle("GET", "/query", hdr, b"") == \
        jd.handle("GET", "/query", hdr, b"")
    assert json.loads(td.handle("GET", "/healthz", {}, b"")[2]) == \
        json.loads(jd.handle("GET", "/healthz", {}, b"")[2])
    # POST /search, binary kind 11 → 12
    req = wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
        q[:4], probes[:4].astype(np.int64), np.array([10], np.uint32),
    ])
    ct = {"content-type": wire_bin.CONTENT_TYPE}
    ra, rb = td.handle("POST", "/search", ct, req), \
        jd.handle("POST", "/search", ct, req)
    assert ra[0] == rb[0] == 200 and ra[1] == rb[1]
    ka, (ids_t, d_t) = wire_bin.decode(ra[2])
    kb, (ids_j, d_j) = wire_bin.decode(rb[2])
    assert ka == kb == wire_bin.KIND_SEARCH and ids_t.dtype == np.int64
    _assert_same_results(ids_t, d_t, ids_j, d_j)
    # errors answer like the JAX dispatcher
    for method, path, h, body in (
        ("POST", "/search", {}, req), ("POST", "/search", ct, b"junk!!!!"),
        ("GET", "/nope", {}, b""), ("PUT", "/search", ct, req),
    ):
        assert td.handle(method, path, h, body)[0] == \
            jd.handle(method, path, h, body)[0]
    stats = json.loads(td.handle("GET", "/stats", {}, b"")[2])
    assert stats["POST /search"]["count"] == 3
    assert stats["POST /search"]["errors"] == 2


def test_init_index_cold_then_warm_and_cross_load(setup, tmp_path,
                                                  monkeypatch):
    """Cold path builds, trains and saves; a second engine warm-loads the
    artifact; the JAX package loads the port's artifact too, and all three
    answer the same."""
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    data, cfg, _, _, q, _ = setup
    write_fvecs(str(tmp_path / "learn.fvecs"), data["train"])
    write_fvecs(str(tmp_path / "base.fvecs"), data["base"])
    tc = _t_config(cfg)
    tc = tcfg.PipelineConfig(
        index=tc.index, protocol=tc.protocol, nbase=tc.nbase,
        train_path=str(tmp_path / "learn.fvecs"),
        base_path=str(tmp_path / "base.fvecs"),
    )
    cold = TEngine(tc, index_dir=str(tmp_path), device="cpu")
    cold.init_index()
    artifact = tmp_path / tc.index.artifact_name()
    assert artifact.exists()
    warm = TEngine(tc, index_dir=str(tmp_path), device="cpu")
    warm.init_index()
    assert torch.equal(warm.index.list_recon, cold.index.list_recon)
    cents = cold.retrieve_centroids()
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6]
    for e in (cold, warm):
        e.serve_tile = 64
        e._tiled = None
    ids_c, d_c = cold.search_fused(q[:4], probes[:4], 10)
    ids_w, d_w = warm.search_fused(q[:4], probes[:4], 10)
    np.testing.assert_array_equal(ids_c, ids_w)
    np.testing.assert_array_equal(d_c, d_w)
    je = JEngine(cfg)
    je.serve_tile = 64
    je.set_index(j_load(str(artifact)), data["base"])
    je._dispatch_union_scan_pruned = _pallas_route
    ids_j, d_j = je.search_fused(q[:4], probes[:4], 10)
    _assert_same_results(ids_c, d_c, ids_j, d_j)
