"""Port parity: the whole slice. ``query_pipeline(..., device="cpu")`` on each
of its five scan branches against the same composition of JAX functions that
bench.py ``tpu_pipeline`` makes (tiled view → centroid ranking → probe
expansion → scan → segmented top-k → id resolve → exact re-rank → top-k),
built here with ``interpret=True`` wherever it reaches a Pallas kernel.

Both sides get the same index (the JAX index's fields through
``index_from_numpy``), base and queries. Tolerances: the final distances are
exact re-rank distances, held to rtol 1e-6; final ids equal except where two
exact distances of a row tie (SIFT-style integer data makes ties real)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index import build as jb
from prefhetch_tpu.index.tiling import build_tiled_view as j_tiled
from prefhetch_tpu.ops import pallas_scan as jp
from prefhetch_tpu.ops import union_scan as jus
from prefhetch_tpu.ops.distances import rank_centroids as j_rank
from prefhetch_tpu.ops.rerank import exact_rerank as j_rerank
from prefhetch_tpu.ops.topk import PAD_DISTANCE as J_PAD
from prefhetch_tpu.ops.topk import topk_select_segmented as j_topk_seg
from prefhetch_tpu.utils.config import IndexParams as JParams
from prefhetch_tpu_torch import pipeline as tp
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.ops import pq_onehot as k3
from prefhetch_tpu_torch.ops import slab_scan as k45
from prefhetch_tpu_torch.ops import union_scan_min as k1
from prefhetch_tpu_torch.utils.config import IndexParams as TParams

torch.set_num_threads(1)

KW = dict(d=32, nlist=16, pq_m=8, pq_nbits=8, kmeans_iters=6,
          pq_kmeans_iters=6)
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")
NPROBE, COARSE_PROBE, K, TILE, PRUNE_J = 6, 48, 10, 64, 4


@pytest.fixture(scope="module")
def data():
    return make_clustered_dataset(
        nbase=3000, ntrain=3000, nquery=9, d=32, n_clusters=24, gt_k=10,
        seed=3,
    )


@pytest.fixture(scope="module")
def indexes(data):
    """(JAX index, the port's index from its fields), PQ with a bf16 recon."""
    j = jb.build_ivf_index(data["train"], data["base"], JParams(**KW))
    arrays = {f: np.asarray(getattr(j, f)) for f in FIELDS
              if getattr(j, f) is not None}
    return j, index_from_numpy(arrays, TParams(**vars(j.params)),
                               device="cpu")


def jax_pipeline(index, base, queries, quant, scan, prune_j):
    """bench.py tpu_pipeline's composition at this test's settings, Pallas in
    interpret mode. Returns (distances [nq, K], ids [nq, K], kept tiles)."""
    view = j_tiled(index, tile=TILE, quant=quant)
    T = view.tile
    q = jnp.asarray(queries)
    _, probes = j_rank(q, index.centroids, NPROBE)
    tiles_np, _ = view.expand_probes(np.asarray(probes))
    tiles = jnp.asarray(tiles_np)
    max_t = tiles_np.shape[1]
    sel = None
    j_keep = 0
    if quant == "pq" or scan == "union":
        union_np, pos_np = jus.union_probe_tiles(tiles_np, view.empty_tile)
        union, pos = jnp.asarray(union_np), jnp.asarray(pos_np)
    if quant == "pq":
        dist = jus.union_pq_scan_distances_pallas(
            view.payload, view.sizes, jnp.asarray(view.tile_list_np),
            index.centroids, index.codebooks, q, union, pos,
            by_residual=bool(index.params.by_residual), interpret=True)
    elif quant == "sq8":
        dist = jp.pallas_slab_distances_sq8(
            view.payload, view.norms, view.sizes, view.sq_vmin,
            view.sq_scale, q, tiles, interpret=True)
    elif scan == "union":
        j_keep = min(prune_j, max_t)
        if j_keep * T < COARSE_PROBE:
            j_keep = 0
        if j_keep:
            dist, sel = jus.union_scan_pruned_fused(
                view.payload, view.norms, view.sizes, q, union, pos,
                j_keep=j_keep, interpret=True)
        else:
            dist = jus.union_scan_distances(
                view.payload, view.norms, view.sizes, q, union, pos)
    else:
        dist = jp.pallas_slab_distances(
            view.payload, view.norms, view.sizes, q, tiles, interpret=True)
    _, p = j_topk_seg(dist, COARSE_PROBE, j_keep or max_t, level1_bf16=True)
    if sel is not None:
        tiles = jnp.take_along_axis(tiles, sel, axis=1)
    tile_sel = jnp.take_along_axis(tiles, p // T, axis=1)
    cand = view.ids[tile_sel, p % T]
    pad = cand < 0
    cand = jnp.maximum(cand, 0)
    pd = j_rerank(jnp.asarray(base), q, cand)
    pd = jnp.where(pad, J_PAD, pd)
    neg, order = jax.lax.top_k(-pd, K)
    return (np.asarray(-neg),
            np.asarray(jnp.take_along_axis(cand, order, axis=1)), j_keep)


BRANCHES = [
    # quant, scan, prune_j, the plain version the CPU run must reach
    ("pq", "union", None, k3.pq_probed_distances_plain),
    ("sq8", "union", None, k45.slab_distances_sq8_plain),
    ("none", "union", PRUNE_J, k1.union_scan_min_reference),
    ("none", "union", 0, None),
    ("none", "slab", None, k45.slab_distances_plain),
]


@pytest.mark.parametrize("quant,scan,prune_j,plain", BRANCHES, ids=[
    "pq-K3", "sq8-K4", "union-pruned-K1", "union-unpruned", "slab-K5"])
def test_query_pipeline_matches_jax_composition(quant, scan, prune_j, plain,
                                                data, indexes):
    j, p = indexes
    base = data["base"].astype(np.float32)
    queries = data["query"].astype(np.float32)
    d_j, i_j, j_keep = jax_pipeline(j, base, queries, quant, scan,
                                    PRUNE_J if prune_j is None else prune_j)

    wrappers = (k1.union_scan_min, k3.pq_probed_distances,
                k45.slab_distances, k45.slab_distances_sq8)
    plains = (k1.union_scan_min_reference, k3.pq_probed_distances_plain,
              k45.slab_distances_plain, k45.slab_distances_sq8_plain)
    launches = [w.launches for w in wrappers]
    calls = {f: f.calls for f in plains}
    step, args, stats = tp.query_pipeline(
        p, base, queries, nprobe=NPROBE, coarse_probe=COARSE_PROBE, k=K,
        quant=quant, scan=scan, tile=TILE, prune_j=prune_j, device="cpu")
    d_t, i_t = step(*args)
    # on CPU tensors the branch's wrapper took its plain version, once, and
    # no other kernel's; nothing was launched
    assert [w.launches for w in wrappers] == launches
    for f in plains:
        assert f.calls - calls[f] == int(f is plain), f.__name__
    assert stats["prune_j"] == j_keep
    assert d_t.shape == (len(queries), K) and d_t.dtype == torch.float32
    d_t, i_t = d_t.numpy(), i_t.numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)
    gap = np.diff(d_j, axis=1) == 0
    tied = np.zeros_like(d_j, bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    np.testing.assert_array_equal(i_t[~tied], i_j[~tied])
    # the returned distances are the exact distances of the returned ids
    exact = ((base[i_t].astype(np.float64)
              - queries[:, None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(d_t, exact, rtol=1e-6)

    # the per-stage functions compose to the same answer
    fns = stats["stage_fns"](args)
    assert list(fns) == ["scan", "topk", "tail"]
    d_s, i_s = fns["tail"]()
    np.testing.assert_array_equal(d_s.numpy(), d_t)
    np.testing.assert_array_equal(i_s.numpy(), i_t)
    assert stats["tiles_per_query"] == args[6].shape[1]
    assert stats["scan_bytes_per_query"] > 0


def test_default_tile_and_view_reuse(indexes, data):
    _, p = indexes
    assert tp.default_tile("pq") == 256
    assert tp.default_tile("none") == tp.default_tile("sq8") == 1024
    q = data["query"].astype(np.float32)
    step, args, stats = tp.query_pipeline(
        p, data["base"], q[:3], nprobe=4, coarse_probe=20, k=5, quant="sq8",
        tile=TILE, device="cpu")
    assert stats["view"].tile == TILE and args[0].dtype == torch.uint8
    # a second batch on the same view: no second re-pack
    step2, args2, stats2 = tp.query_pipeline(
        p, data["base"], q[3:], nprobe=4, coarse_probe=20, k=5, quant="sq8",
        device="cpu", view=stats["view"])
    assert stats2["view"] is stats["view"] and args2[0] is args[0]
    d, ids = step2(*args2)
    assert d.shape == (len(q) - 3, 5) and bool((d[:, 1:] >= d[:, :-1]).all())
    assert int(ids.min()) >= 0


def test_query_pipeline_refusals(monkeypatch, indexes, data):
    _, p = indexes
    q = data["query"].astype(np.float32)
    with pytest.raises(ValueError, match="unknown quant"):
        tp.query_pipeline(p, data["base"], q, quant="int4", device="cpu")
    with pytest.raises(ValueError, match="unknown scan"):
        tp.query_pipeline(p, data["base"], q, scan="lists", device="cpu")
    # the default device is the card: without CUDA it raises, it does not
    # carry on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.query_pipeline(p, data["base"], q)
