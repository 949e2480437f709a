"""Port parity: the triage-search ops and kernel K1's plain version.

The same inputs (numpy seeds) go through the JAX function and the port's
counterpart. The JAX side's Pallas kernel runs in interpret mode, as the JAX
package's own tests run it (tests/test_union_scan.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index.build import build_ivf_index as j_build
from prefhetch_tpu.index.tiling import build_tiled_view as j_tiled
from prefhetch_tpu.ops import distances as j_dist
from prefhetch_tpu.ops import rerank as j_rerank
from prefhetch_tpu.ops import topk as j_topk
from prefhetch_tpu.ops import union_scan as j_us
from prefhetch_tpu.ops.pallas_scan import pallas_union_scan_min
from prefhetch_tpu.utils.config import IndexParams
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.index.tiling import build_tiled_view as t_tiled
from prefhetch_tpu_torch.ops import distances as t_dist
from prefhetch_tpu_torch.ops import rerank as t_rerank
from prefhetch_tpu_torch.ops import topk as t_topk
from prefhetch_tpu_torch.ops import union_scan as t_us
from prefhetch_tpu_torch.ops.union_scan_min import union_scan_min
from prefhetch_tpu_torch.utils.config import IndexParams as TParams

torch.set_num_threads(1)

PAD = 3.4e38
KW = dict(d=32, nlist=16, pq_m=8, pq_nbits=8, kmeans_iters=6,
          pq_kmeans_iters=6)
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")


@pytest.fixture(scope="module")
def data():
    return make_clustered_dataset(
        nbase=3000, ntrain=3000, nquery=8, d=32, n_clusters=24, gt_k=10,
        seed=3,
    )


@pytest.fixture(scope="module")
def views(data):
    """{payload kind: (JAX view, port view, probes, tile_idx, union, pos)}
    for a bf16 (PQ recon) and an f32 (flat) payload, tile 64."""
    out = {}
    q = data["query"]
    for kind, kw in (("bf16", KW), ("f32", dict(KW, pq_m=0))):
        j_idx = j_build(data["train"], data["base"], IndexParams(**kw))
        arrays = {f: np.asarray(getattr(j_idx, f)) for f in FIELDS
                  if getattr(j_idx, f) is not None}
        t_idx = index_from_numpy(arrays, TParams(**kw), device="cpu")
        jv, tv = j_tiled(j_idx, tile=64), t_tiled(t_idx, tile=64)
        cent = np.asarray(j_idx.centroids)
        probes = np.argsort(((q[:, None] - cent[None]) ** 2).sum(-1),
                            axis=1, kind="stable")[:, :4]
        tile_idx, _ = jv.expand_probes(probes)
        union, pos = j_us.union_probe_tiles(tile_idx, jv.empty_tile)
        out[kind] = (jv, tv, probes, tile_idx, union, pos)
    return out


def _j_args(view, q, union, pos):
    return (view.payload, view.norms, view.sizes, jnp.asarray(q),
            jnp.asarray(union), jnp.asarray(pos))


def _t_args(view, q, union, pos):
    return (view.payload, view.norms, view.sizes, torch.from_numpy(q),
            torch.from_numpy(union.astype(np.int32)), torch.from_numpy(pos))


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_union_probe_tiles_identical(views):
    jv, _, _, tile_idx, union, pos = views["bf16"]
    u, p = t_us.union_probe_tiles(tile_idx, jv.empty_tile)
    np.testing.assert_array_equal(u, union)
    np.testing.assert_array_equal(p, pos)
    assert len(u) % 128 == 0 and u[-1] == jv.empty_tile


def test_rank_centroids_matches(data):
    q = data["query"]
    cent = np.random.default_rng(4).uniform(0, 255, (16, 32)).astype(
        np.float32)
    jd, ji = j_dist.rank_centroids(jnp.asarray(q), jnp.asarray(cent), 5)
    td, ti = t_dist.rank_centroids(torch.from_numpy(q),
                                   torch.from_numpy(cent), 5)
    # f32 expansion with sums in another order: rtol 1e-5
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_union_scan_min_plain_matches_pallas(data, views, kind):
    """K1's plain version against the Pallas kernel (interpret mode): same
    PAD lanes (+inf after the bf16 cast), d2 within one bf16 ulp, tile
    minima within f32 summation-order error."""
    jv, tv, _, _, union, _ = views[kind]
    q = data["query"]
    jd2, jmin = pallas_union_scan_min(
        jv.payload, jv.norms, jv.sizes, jnp.asarray(q), jnp.asarray(union),
        interpret=True,
    )
    td2, tmin = union_scan_min(tv.payload, tv.norms, tv.sizes,
                               torch.from_numpy(q),
                               torch.from_numpy(union.astype(np.int32)))
    jd2, td2 = _as_f32(jd2), _as_f32(td2)
    assert td2.shape == jd2.shape and tmin.shape == jmin.shape
    np.testing.assert_array_equal(np.isinf(td2), np.isinf(jd2))
    ok = ~np.isinf(jd2)
    np.testing.assert_allclose(td2[ok], jd2[ok], rtol=1e-2, atol=0.5)
    # f32 sums of 32 products in another order: a few ulp of ~1e6 terms
    np.testing.assert_allclose(tmin.numpy(), np.asarray(jmin), rtol=1e-5,
                               atol=0.5)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_union_scan_pruned_fused_matches_jax(data, views, kind):
    """The port's K1 route against the JAX Pallas route (interpret mode):
    the same kept tiles (compared as sets: the two sides may order tiles
    whose minima tie differently; this fixture has no tie at the j-th
    minimum, so the sets are equal), each kept tile's distances within one
    bf16 ulp, PAD patterns equal."""
    jv, tv, _, _, union, pos = views[kind]
    q = data["query"]
    T = jv.tile
    for j in (2, pos.shape[1]):
        jd, jsel = j_us.union_scan_pruned_fused(*_j_args(jv, q, union, pos),
                                                j, interpret=True)
        td, tsel = t_us.union_scan_pruned_fused(*_t_args(tv, q, union, pos),
                                                j)
        jd, jsel, tsel = _as_f32(jd), np.asarray(jsel), tsel.numpy()
        td = _as_f32(td)
        assert td.shape == jd.shape and tsel.shape == jsel.shape
        for qi in range(q.shape[0]):
            assert set(tsel[qi]) == set(jsel[qi]), qi
            order_t = np.argsort(tsel[qi])
            order_j = np.argsort(jsel[qi])
            bt = td[qi].reshape(j, T)[order_t]
            bj = jd[qi].reshape(j, T)[order_j]
            np.testing.assert_array_equal(np.isinf(bt), np.isinf(bj))
            ok = ~np.isinf(bj)
            np.testing.assert_allclose(bt[ok], bj[ok], rtol=1e-2, atol=0.5)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_f32_union_scans_match_jax(data, views, kind):
    """The unpruned and pruned f32 formulations (XLA in the JAX package,
    plain PyTorch here): rtol 1e-5 for f32 sums in another order."""
    jv, tv, _, _, union, pos = views[kind]
    q = data["query"]
    jd = np.asarray(j_us.union_scan_distances(*_j_args(jv, q, union, pos)))
    td = t_us.union_scan_distances(*_t_args(tv, q, union, pos)).numpy()
    np.testing.assert_array_equal(td >= PAD / 2, jd >= PAD / 2)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=0.5)
    j = 3
    jd, jsel = j_us.union_scan_pruned(*_j_args(jv, q, union, pos), j)
    td, tsel = t_us.union_scan_pruned(*_t_args(tv, q, union, pos), j)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=0.5)


def test_dropped_union_padding_changes_nothing(data, views):
    """The JAX engine pads the union to a power of two (only to pin XLA
    shapes); the port does not. The pruned scan's outputs are identical
    with and without that padding."""
    _, tv, _, tile_idx, union, pos = views["bf16"]
    q = data["query"]
    padded = np.concatenate([union, np.full(512 - len(union), union[-1])])
    a = t_us.union_scan_pruned_fused(*_t_args(tv, q, union, pos), 3)
    b = t_us.union_scan_pruned_fused(*_t_args(tv, q, padded, pos), 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [5, 70])
def test_topk_select_segmented_both_branches(data, views, dtype, k):
    """k < seg takes the two-level branch (level1_bf16 on), k ≥ seg the flat
    collapse. Same values and positions as the JAX package (ties break
    toward the lower index on both sides)."""
    jv, tv, _, _, union, pos = views["bf16"]
    q = data["query"]
    d = np.asarray(j_us.union_scan_distances(*_j_args(jv, q, union, pos)))
    n_seg = pos.shape[1]                      # segments of T = 64 lanes
    jx = jnp.asarray(d) if dtype == "f32" else \
        jnp.asarray(d).astype(jnp.bfloat16)
    tx = torch.tensor(d)
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    jv_, ji = j_topk.topk_select_segmented(jx, k, n_seg, level1_bf16=True)
    tv_, ti = t_topk.topk_select_segmented(tx, k, n_seg, level1_bf16=True)
    assert tv_.dtype == tx.dtype
    np.testing.assert_array_equal(_as_f32(tv_), _as_f32(jv_))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jv2, ji2 = j_topk.topk_select(jnp.asarray(d), k)
    tv2, ti2 = t_topk.topk_select(torch.tensor(d), k)
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))


def test_resolve_rerank_final_topk_match(data, views):
    """Id resolve, exact re-rank (with a -1 pad id, which both gathers wrap
    to the last row) and the final top-k: exact on SIFT-style integer data,
    where every f32 sum is exact."""
    jv, tv, _, tile_idx, union, pos = views["bf16"]
    q = data["query"]
    d = np.asarray(j_us.union_scan_distances(*_j_args(jv, q, union, pos)))
    _, jpos = j_topk.topk_select(jnp.asarray(d), 20)
    jpos = np.array(jpos)                 # a writable copy for torch
    jids = np.asarray(j_us.resolve_topk_ids(
        jnp.asarray(jpos), jnp.asarray(tile_idx), jv.ids))
    tids = t_us.resolve_topk_ids(torch.from_numpy(jpos),
                                 torch.from_numpy(tile_idx), tv.ids)
    np.testing.assert_array_equal(tids.numpy(), jids)
    cand = jids.copy()
    cand[0, -1] = -1
    base = data["base"]
    js = np.asarray(j_rerank.exact_rerank(jnp.asarray(base), jnp.asarray(q),
                                          jnp.asarray(cand)))
    ts = t_rerank.exact_rerank(torch.from_numpy(base), torch.from_numpy(q),
                               torch.from_numpy(cand))
    np.testing.assert_array_equal(ts.numpy(), js)
    ji, jdist = j_rerank.final_topk(jnp.asarray(js), jnp.asarray(cand), 7)
    ti, tdist = t_rerank.final_topk(ts, torch.from_numpy(cand), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(
        t_rerank.fetch_vectors(torch.from_numpy(base),
                               torch.from_numpy(cand[:, :3])).numpy(),
        base[cand[:, :3]])
