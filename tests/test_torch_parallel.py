"""Port parity: the sharded services of parallel/ (mesh, sharded, dryrun).

Counterparts of tests/test_parallel.py on CPU meshes of 1, 2, 4 and 8
shards (``devices=["cpu"] * k``, the port's stand-in for the JAX suite's
virtual 8-device CPU backend), held BIT-equal to the port's single-device
functions (the JAX tests allow rtol 1e-5 for the scan and re-rank
distances; the port computes each value by the unsharded arithmetic). Then
each port sharded function against the JAX sharded function on the JAX
suite's 8-device mesh, on the same numpy inputs: ids, masks, counts and
kept tiles equal; f32 distances as the unsharded parity tests hold them
(rtol 1e-5), K1's bf16 ones within one bf16 ulp. Last, the port's dry run
(``dryrun_multichip(4, device="cpu")``) and the mesh's refusals."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index.build import build_ivf_index as j_build
from prefhetch_tpu.index.tiling import build_tiled_view as j_tiled
from prefhetch_tpu.ops.union_scan import union_probe_tiles as j_union
from prefhetch_tpu.parallel import mesh as j_mesh
from prefhetch_tpu.parallel import sharded as J
from prefhetch_tpu.utils.config import IndexParams
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.index.tiling import build_tiled_view as t_tiled
from prefhetch_tpu_torch.ops.rerank import (
    exact_rerank, fetch_vectors, final_topk,
)
from prefhetch_tpu_torch.ops.scan import coarse_scan_flat
from prefhetch_tpu_torch.ops.union_scan import (
    union_probe_tiles, union_scan_distances, union_scan_distances_q16,
    union_scan_pruned_fused,
)
from prefhetch_tpu_torch.parallel import sharded as S
from prefhetch_tpu_torch.parallel.dryrun import dryrun_multichip
from prefhetch_tpu_torch.parallel.mesh import make_mesh
from prefhetch_tpu_torch.parallel.multihost import init_multihost
from prefhetch_tpu_torch.utils.config import IndexParams as TParams

torch.set_num_threads(1)

MESHES = [1, 2, 4, 8]
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")


def _cpu_mesh(k):
    return make_mesh(devices=["cpu"] * k)


@pytest.fixture(scope="module")
def data():
    return make_clustered_dataset(
        nbase=2048, ntrain=4000, nquery=8, d=32, n_clusters=40, gt_k=50,
        seed=9,
    )


@pytest.fixture(scope="module", params=["flat", "pq"])
def built(request, data):
    """(JAX index, port index from its arrays, probes [8, 6])."""
    kw = dict(d=32, nlist=16, pq_m=0 if request.param == "flat" else 8,
              pq_nbits=8, kmeans_iters=8, pq_kmeans_iters=8)
    j_idx = j_build(data["train"], data["base"], IndexParams(**kw))
    arrays = {f: np.asarray(getattr(j_idx, f)) for f in FIELDS
              if getattr(j_idx, f) is not None}
    t_idx = index_from_numpy(arrays, TParams(**kw), device="cpu")
    cent = arrays["centroids"]
    q = data["query"]
    probes = np.argsort(((q[:, None] - cent[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6]
    return j_idx, t_idx, probes


def _equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# -- counterparts of tests/test_parallel.py, against one device --------------

@pytest.mark.parametrize("k", MESHES)
def test_sharded_scan_matches_single_device(built, data, k):
    _, idx, probes = built
    q = torch.from_numpy(data["query"])
    p = torch.from_numpy(probes)
    payload = idx.list_recon if idx.uses_pq else idx.list_vectors
    ref = coarse_scan_flat(payload, idx.list_ids, idx.list_sizes, q, p,
                           idx.list_norms)
    mesh = _cpu_mesh(k)
    got = S.sharded_coarse_scan(mesh, S.shard_index(idx, mesh), q, p)
    for f in ref._fields:
        _equal(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("k", MESHES)
def test_sharded_rerank_matches(data, k):
    rng = np.random.default_rng(0)
    base = torch.from_numpy(data["base"])
    q = torch.from_numpy(data["query"])
    cand = torch.from_numpy(rng.integers(0, 2048, (8, 40)).astype(np.int32))
    cand[0, 0] = -1                 # wraps to the last row, as unsharded
    mesh = _cpu_mesh(k)
    _equal(S.sharded_rerank(mesh, S.shard_rows(base, mesh), q, cand),
           exact_rerank(base, q, cand))


@pytest.mark.parametrize("k", MESHES)
def test_sharded_fetch_matches(data, k):
    rng = np.random.default_rng(1)
    base = torch.from_numpy(data["base"]).clone()
    base[5, 3] = -0.0               # passes the owner sum unchanged
    ids = torch.from_numpy(rng.integers(0, 2048, (4, 10)).astype(np.int32))
    ids[0, 0] = 5
    mesh = _cpu_mesh(k)
    got = S.sharded_fetch(mesh, S.shard_rows(base, mesh), ids)
    _equal(got, fetch_vectors(base, ids))
    assert torch.signbit(got[0, 0, 3])


@pytest.mark.parametrize("k", MESHES)
def test_sharded_kmeans_step_matches_host(data, k):
    x = data["train"][:2048].astype(np.float32)
    c0 = data["train"][:16].astype(np.float32)
    mesh = _cpu_mesh(k)
    new_c, counts = S.sharded_kmeans_step(mesh, S.shard_rows(x, mesh),
                                          torch.from_numpy(c0))
    d2 = ((x[:, None, :] - c0[None]) ** 2).sum(-1)
    a = d2.argmin(1)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(a, minlength=16))
    for j in np.unique(a):
        np.testing.assert_allclose(new_c.numpy()[j], x[a == j].mean(0),
                                   rtol=1e-4)


def test_shard_index_requires_divisibility(data):
    from prefhetch_tpu_torch.index.build import build_ivf_index

    params = TParams(d=32, nlist=12, pq_m=0, kmeans_iters=3)
    idx = build_ivf_index(data["train"][:2000], data["base"][:500], params,
                          device="cpu")
    with pytest.raises(ValueError, match="nlist=12 not divisible by 8 "
                                         "devices"):
        S.shard_index(idx, _cpu_mesh(8))
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        S.shard_rows(torch.zeros(500, 4), _cpu_mesh(3))


@pytest.mark.parametrize("k", MESHES)
def test_shards_on_one_device_are_views(built, data, k):
    """A k-shard mesh on one device adds no index or base memory: every
    shard is a slice of the unsharded tensor (the last base shard pads)."""
    _, idx, _ = built
    mesh = _cpu_mesh(k)
    sidx = S.shard_index(idx, mesh)
    for s, sh in enumerate(sidx.shards):
        assert sh.list_ids.data_ptr() == \
            idx.list_ids[s * sidx.nlist_local].data_ptr()
    base = torch.from_numpy(data["base"][:2045])
    rows = S.shard_rows(base, mesh, pad=True)
    for s, sh in enumerate(rows.shards[:-1] if 2045 % k else rows.shards):
        assert sh.data_ptr() == base[s * rows.rows_l].data_ptr()
    assert rows.nrows == 2045 and rows.rows_l * k >= 2045


# -- the tiled scans, against one device --------------------------------------

@pytest.fixture(scope="module")
def tiled(built, data):
    """(port view, tile ids, union, pos) at tile 64."""
    _, idx, probes = built
    view = t_tiled(idx, tile=64)
    tiles, _ = view.expand_probes(probes.astype(np.int64))
    union, pos = union_probe_tiles(tiles, view.empty_tile)
    return view, tiles, union, pos


@pytest.mark.parametrize("k", MESHES)
def test_sharded_union_scans_bit_equal(tiled, data, k):
    view, tiles, union, pos = tiled
    q = torch.from_numpy(data["query"])
    args = (view.payload, view.norms, view.sizes, q,
            torch.from_numpy(union.astype(np.int32)), torch.from_numpy(pos))
    mesh = _cpu_mesh(k)
    st = S.shard_tiled_view(view, mesh)
    assert st.ntp % k == 0 and st.ntp >= view.payload.shape[0]
    ud, pd, u_loc = S.partition_union(union, pos, view.empty_tile, st.tpl, k)
    assert ud.shape == (k, u_loc)
    dist = S.sharded_union_scan(mesh, st, q, ud, pd)
    _equal(dist, union_scan_distances(*args))
    for a, b in zip(S.sharded_union_scan_q16(mesh, st, q, ud, pd),
                    union_scan_distances_q16(*args)):
        _equal(a, b)
    for j in (2, tiles.shape[1]):
        for a, b in zip(S.sharded_union_scan_pruned(mesh, st, q, ud, pd, j),
                        union_scan_pruned_fused(*args, j)):
            _equal(a, b)
    base = torch.from_numpy(data["base"])
    cand = torch.from_numpy(
        np.random.default_rng(2).integers(0, 2048, (8, 64)).astype(np.int32))
    for a, b in zip(
            S.sharded_fused_tail(mesh, S.shard_rows(base, mesh), q, cand, 16),
            final_topk(exact_rerank(base, q, cand), cand, 16)):
        _equal(a, b)


def test_union_distances_do_not_depend_on_the_union(tiled, data):
    """Hazard: a product at another shape may sum in another order. Each
    tile's distances are equal whatever union (or shard share) it came in."""
    from prefhetch_tpu_torch.ops.union_scan_min import union_distances

    view, _, union, _ = tiled
    q = torch.from_numpy(data["query"])
    u = torch.from_numpy(union.astype(np.int32))
    full = union_distances(view.payload, view.norms, view.sizes, q, u)
    for lo, hi in ((0, 1), (3, 40), (5, u.shape[0])):
        part = union_distances(view.payload, view.norms, view.sizes, q,
                               u[lo:hi])
        _equal(part, full[lo:hi])


# -- against the JAX sharded functions on the JAX suite's 8-device mesh ------

@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= 8, "conftest must force 8 CPU devices"
    return j_mesh.make_mesh(8)


def _rows(jm, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(jm, P("lists")))


def test_sharded_scan_rerank_fetch_match_jax(built, data, jmesh):
    j_idx, t_idx, probes = built
    q = data["query"]
    jr = J.sharded_coarse_scan(jmesh, J.shard_index(j_idx, jmesh),
                               jnp.asarray(q), jnp.asarray(probes))
    mesh = _cpu_mesh(8)
    tr = S.sharded_coarse_scan(mesh, S.shard_index(t_idx, mesh),
                               torch.from_numpy(q), torch.from_numpy(probes))
    m = np.asarray(jr.mask)
    np.testing.assert_array_equal(tr.mask.numpy(), m)
    np.testing.assert_array_equal(tr.counts.numpy(), np.asarray(jr.counts))
    np.testing.assert_array_equal(tr.ids.numpy()[m], np.asarray(jr.ids)[m])
    np.testing.assert_allclose(tr.distances.numpy()[m],
                               np.asarray(jr.distances)[m], rtol=1e-5,
                               atol=0.5)
    base = data["base"]
    cand = np.random.default_rng(3).integers(0, 2048, (8, 40)).astype(
        np.int32)
    jd = J.sharded_rerank(jmesh, _rows(jmesh, base), jnp.asarray(q),
                          jnp.asarray(cand))
    td = S.sharded_rerank(mesh, S.shard_rows(base, mesh),
                          torch.from_numpy(q), torch.from_numpy(cand))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=0.5)
    jf = J.sharded_fetch(jmesh, _rows(jmesh, base), jnp.asarray(cand[:, :5]))
    tf = S.sharded_fetch(mesh, S.shard_rows(base, mesh),
                         torch.from_numpy(cand[:, :5]))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_sharded_kmeans_step_matches_jax(data, jmesh):
    x = data["train"][:2048].astype(np.float32)
    c0 = data["train"][:16].astype(np.float32)
    jc, jn = J.sharded_kmeans_step(jmesh, _rows(jmesh, x), jnp.asarray(c0))
    mesh = _cpu_mesh(8)
    tc, tn = S.sharded_kmeans_step(mesh, S.shard_rows(x, mesh),
                                   torch.from_numpy(c0))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-3)


def test_partition_union_and_tiled_scans_match_jax(built, data, jmesh):
    """partition_union bit-equal to the JAX package's at its (power-of-two)
    u_loc; the sharded f32 and q16 scans and the fused tail within the
    unsharded parity tolerances; the pruned scan (K1's plain version in the
    port, f32 XLA in JAX): the same kept tiles, distances within a bf16
    ulp."""
    j_idx, t_idx, probes = built
    q = data["query"]
    jv, tv = j_tiled(j_idx, tile=64), t_tiled(t_idx, tile=64)
    tiles, _ = jv.expand_probes(probes.astype(np.int64))
    union, pos = j_union(tiles, jv.empty_tile)
    jst = J.shard_tiled_view(jv, jmesh)
    mesh = _cpu_mesh(8)
    tst = S.shard_tiled_view(tv, mesh)
    assert (tst.ntp, tst.tpl) == (jst.ntp, jst.tpl)
    jud, jpd, ju = J.partition_union(union, pos, jv.empty_tile, jst.tpl, 8)
    tud, tpd, tu = S.partition_union(union, pos, tv.empty_tile, tst.tpl, 8,
                                     u_loc=ju)
    assert tu == ju
    np.testing.assert_array_equal(tud, jud)
    np.testing.assert_array_equal(tpd, jpd)
    jd = np.asarray(J.sharded_union_scan(jmesh, jst, jnp.asarray(q), jud, jpd))
    td = S.sharded_union_scan(mesh, tst, torch.from_numpy(q), tud, tpd)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=0.5)
    jq = J.sharded_union_scan_q16(jmesh, jst, jnp.asarray(q), jud, jpd)
    tq = S.sharded_union_scan_q16(mesh, tst, torch.from_numpy(q), tud, tpd)
    np.testing.assert_allclose(tq[1].numpy(), np.asarray(jq[1]), rtol=1e-5,
                               atol=0.5)
    assert np.abs(tq[0].numpy().astype(np.int64)
                  - np.asarray(jq[0]).astype(np.int64)).max() <= 1
    j = 2
    jpdist, jsel = J.sharded_union_scan_pruned(jmesh, jst, jnp.asarray(q),
                                               jud, jpd, j)
    tpdist, tsel = S.sharded_union_scan_pruned(mesh, tst,
                                               torch.from_numpy(q), tud,
                                               tpd, j)
    jsel, tsel = np.asarray(jsel), tsel.numpy()
    jpdist = np.asarray(jpdist)
    tpdist = tpdist.to(torch.float32).numpy()
    T = tv.tile
    for qi in range(q.shape[0]):
        assert set(tsel[qi]) == set(jsel[qi]), qi
        bt = tpdist[qi].reshape(j, T)[np.argsort(tsel[qi])]
        bj = jpdist[qi].reshape(j, T)[np.argsort(jsel[qi])]
        ok = bj < 3.4e38
        np.testing.assert_array_equal(np.isinf(bt), ~ok)
        np.testing.assert_allclose(bt[ok], bj[ok], rtol=2.0 ** -8, atol=0.5)
    cand = np.random.default_rng(4).integers(0, 2048, (8, 64)).astype(
        np.int32)
    base = data["base"]
    ji, jdk = J.sharded_fused_tail(jmesh, _rows(jmesh, base), jnp.asarray(q),
                                   jnp.asarray(cand), 16)
    ti, tdk = S.sharded_fused_tail(mesh, S.shard_rows(base, mesh),
                                   torch.from_numpy(q),
                                   torch.from_numpy(cand), 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tdk.numpy(), np.asarray(jdk), rtol=1e-5,
                               atol=0.5)


# -- the mesh and the dry run -------------------------------------------------

def test_make_mesh_device_rule_and_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="is_available"):
        init_multihost("127.0.0.1:1", 1, 0)       # before any world forms
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.ndev == 1 and mesh.leader == torch.device("cpu")
    assert _cpu_mesh(4).ndev == 4
    assert [g for g, _ in _cpu_mesh(3).local_shards()] == [0, 1, 2]


def test_dryrun_multichip_on_four_cpu_shards():
    out = dryrun_multichip(4, device="cpu")
    assert out["ok"] is True and out["n_devices"] == 4
    assert sum(out["counts"]) > 0
