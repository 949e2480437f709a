"""Port parity: the slab and ADC kernels' plain versions (K5, K4, K3), the
dense-layout coarse scans (ops/scan.py) and the union PQ scans, each held to
the JAX function on the same numpy-seeded inputs.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU. On CPU tensors each of the port's wrappers takes its plain
version, which is what these tests reach; the CUDA kernels are held to the
same plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
Fixture sizes follow tests/test_union_scan.py (d=32, nlist=16, pq_m=8,
tile=64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index import build as jb
from prefhetch_tpu.index.tiling import build_tiled_view as j_tiled
from prefhetch_tpu.ops import pallas_scan as jp
from prefhetch_tpu.ops import scan as jscan
from prefhetch_tpu.ops import union_scan as jus
from prefhetch_tpu.utils.config import IndexParams as JParams
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.index.tiling import build_tiled_view as t_tiled
from prefhetch_tpu_torch.ops import pq_onehot as k3
from prefhetch_tpu_torch.ops import scan as tscan
from prefhetch_tpu_torch.ops import slab_scan as k45
from prefhetch_tpu_torch.ops import union_scan as tus
from prefhetch_tpu_torch.utils.config import IndexParams as TParams

torch.set_num_threads(1)

PAD = 3.4e38
KW = dict(d=32, nlist=16, pq_m=8, pq_nbits=8, kmeans_iters=6,
          pq_kmeans_iters=6)
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors", "list_sq", "sq_vmin",
          "sq_scale")


def to_port(jidx):
    """The JAX index's own fields → the port's index on the CPU."""
    arrays = {f: np.asarray(getattr(jidx, f)) for f in FIELDS
              if getattr(jidx, f) is not None}
    return index_from_numpy(arrays, TParams(**vars(jidx.params)),
                            device="cpu")


def t(a, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


# -- K5 / K4: synthetic tiles with every edge size ---------------------------

def _slab_case(T, d, nq, seed):
    """Tiles of size T, 1, T−1, 0 and T//2 plus the reserved empty tile;
    probe rows that mix them, one row that is all the empty tile."""
    rng = np.random.default_rng(seed)
    sizes = np.array([T, 1, T - 1, 0, T // 2, 0], np.int32)
    x = rng.normal(scale=40.0, size=(6, T, d)).astype(np.float32)
    for i, s in enumerate(sizes):
        x[i, s:] = 0
    q = rng.normal(scale=40.0, size=(nq, d)).astype(np.float32)
    probes = rng.integers(0, 6, (nq, 4)).astype(np.int32)
    probes[0] = [0, 1, 2, 3]
    probes[-1] = 5                      # a row of nothing but the empty tile
    return x, sizes, q, probes


def _assert_slab_close(got, ref, qsq, xsq_max):
    """Identical PAD pattern; valid lanes within the f32 summation error of
    the distance's three terms, 1e-5·(‖q‖² + ‖x‖²)."""
    pad_g, pad_r = got >= PAD / 2, ref >= PAD / 2
    np.testing.assert_array_equal(pad_g, pad_r)
    tol = 1e-5 * (qsq[:, None] + xsq_max)
    err = np.abs(np.where(pad_r, 0, got - ref))
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.parametrize("T,d,nq,dtype", [
    (64, 32, 5, "f32"), (64, 32, 3, "bf16"), (16, 128, 7, "bf16"),
    (24, 128, 2, "f32"),
])
def test_slab_distances_matches_pallas_interpret(T, d, nq, dtype):
    x, sizes, q, probes = _slab_case(T, d, nq, seed=T + d + nq)
    if dtype == "bf16":
        xt = t(x, torch.bfloat16)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        x = xt.float().numpy()
    else:
        xt, xj = t(x), jnp.asarray(x)
    norms = (x ** 2).sum(-1).astype(np.float32)
    ref = np.asarray(jp.pallas_slab_distances(
        xj, jnp.asarray(norms), jnp.asarray(sizes), jnp.asarray(q),
        jnp.asarray(probes), interpret=True))
    calls = k45.slab_distances_plain.calls
    got = k45.slab_distances(xt, t(norms), t(sizes), t(q), t(probes))
    assert k45.slab_distances_plain.calls == calls + 1
    assert k45.slab_distances.launches == 0
    assert got.dtype == torch.float32 and got.shape == (nq, 4 * T)
    got = got.numpy()
    _assert_slab_close(got, ref, (q ** 2).sum(-1), norms.max())
    # the all-empty row is all PAD; a size-1 tile keeps exactly one lane
    assert (got[-1] == np.float32(PAD)).all()
    assert (got[0, T:2 * T] < PAD / 2).sum() == 1


@pytest.mark.parametrize("T,d,nq", [(64, 32, 5), (16, 128, 3), (40, 48, 2)])
def test_slab_distances_sq8_matches_pallas_interpret(T, d, nq):
    rng = np.random.default_rng(T * d + nq)
    _, sizes, q, probes = _slab_case(T, d, nq, seed=T + d)
    q = np.abs(q) * 3                              # SIFT-like: non-negative
    codes = rng.integers(0, 256, (6, T, d), dtype=np.uint8)
    for i, s in enumerate(sizes):
        codes[i, s:] = 0
    vmin = rng.uniform(-5, 5, d).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, d).astype(np.float32)
    decoded = vmin + (codes.astype(np.float32) + 0.5) * scale
    norms = (decoded ** 2).sum(-1).astype(np.float32)
    ref = np.asarray(jp.pallas_slab_distances_sq8(
        jnp.asarray(codes), jnp.asarray(norms), jnp.asarray(sizes),
        jnp.asarray(vmin), jnp.asarray(scale), jnp.asarray(q),
        jnp.asarray(probes), interpret=True))
    calls = k45.slab_distances_sq8_plain.calls
    got = k45.slab_distances_sq8(t(codes), t(norms), t(sizes), t(vmin),
                                 t(scale), t(q), t(probes))
    assert k45.slab_distances_sq8_plain.calls == calls + 1
    assert k45.slab_distances_sq8.launches == 0
    got = got.numpy()
    _assert_slab_close(got, ref, (q ** 2).sum(-1), norms.max())
    assert (got[-1] == np.float32(PAD)).all()
    # and it is the distance to the decoded vectors
    exact = ((decoded[probes[0, 0]].astype(np.float64)
              - q[0].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(got[0, :T], exact, rtol=1e-4)


def test_slab_wrappers_refuse_bad_arguments():
    x, sizes, q, probes = _slab_case(16, 32, 2, seed=0)
    norms = (x ** 2).sum(-1)
    args = (t(x), t(norms), t(sizes), t(q), t(probes))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k45.slab_distances(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="int32"):
        k45._check(args[0], args[1], args[2], args[3], args[4].long(),
                   (torch.float32,), 8)
    with pytest.raises(ValueError, match="divisible by 16"):
        k45._check(t(x[..., :24].copy()), args[1], args[2], t(q[:, :24]),
                   args[4], (torch.float32,), 16)
    with pytest.raises(ValueError, match="one of"):
        k45._check(args[0].half(), *args[1:], (torch.uint8,), 16)
    with pytest.raises(ValueError, match="vmin must"):
        k45._check(*args, (torch.float32,), 8,
                   affine=(("vmin", torch.zeros(3)),))
    k45._check(*args, (torch.float32,), 8)         # the good case passes


# -- K3 ------------------------------------------------------------------------

def _terms_bound(lutq, lutp, M):
    """Σ_m |term| is at most M·(max|lutq| + max|lutp|)."""
    return M * (np.abs(lutq).max() + np.abs(lutp).max())


@pytest.mark.parametrize("T,M,ksub,nq,nqb,zero_lutp", [
    (8, 4, 16, 3, 2, False),          # nq not a multiple of the TPU block
    (64, 8, 256, 5, 256, False),
    (16, 16, 256, 2, 256, False),     # M a multiple of 16
    (64, 8, 256, 4, 2, True),         # by_residual=False: a zero list part
])
def test_pq_onehot_matches_pallas_interpret(T, M, ksub, nq, nqb, zero_lutp):
    rng = np.random.default_rng(T + M + nq)
    ntiles, nlist = 6, 5
    codes = rng.integers(0, ksub, (ntiles + 1, T, M), dtype=np.uint8)
    codes[-1] = 0
    # LUT entries of mixed sign and size, so the bf16 sum does round
    lutq = (rng.normal(size=(nq, M * ksub)) * 3000).astype(np.float32)
    lutp = np.zeros((nlist, M * ksub), np.float32) if zero_lutp else \
        (rng.normal(size=(nlist, M * ksub)) * 700).astype(np.float32)
    tile_list = rng.integers(0, nlist, ntiles + 1).astype(np.int32)
    union = np.array([4, 0, 1, 6, 6], np.int32)
    ref = np.asarray(jp.pallas_pq_onehot_distances(
        jnp.asarray(codes), jnp.asarray(lutq), jnp.asarray(lutp),
        jnp.asarray(tile_list), jnp.asarray(union), nqb=nqb, interpret=True))
    got = k3.pq_onehot_distances_plain(t(codes), t(lutq), t(lutp),
                                       t(tile_list), t(union))
    assert got.dtype == torch.float32 and got.shape == (nq, len(union) * T)
    # f32 summation error of M terms; a LUT sum rounded otherwise than to the
    # nearest-even bf16 would be off by 2^-9 of a term, far above this
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * _terms_bound(lutq, lutp, M))
    # the contract spelled out: bf16(bf16(lutq) + bf16(lutp)), f32 sum over m
    lut = (t(lutq, torch.bfloat16)[1] + t(lutp, torch.bfloat16)[
        tile_list[union[0]]]).float().numpy()
    want = sum(lut[m * ksub + codes[union[0], :, m].astype(np.int64)]
               for m in range(M))
    np.testing.assert_allclose(got.numpy()[1, :T], want, rtol=1e-6)


# -- the dense-layout scans and the union PQ scans, on built indexes ------------

@pytest.fixture(scope="module")
def data():
    return make_clustered_dataset(
        nbase=3000, ntrain=3000, nquery=8, d=32, n_clusters=24, gt_k=10,
        seed=3,
    )


@pytest.fixture(scope="module")
def indexes(data):
    """{kind: (JAX index, the port's index from its fields)}."""
    out = {}
    for kind, kw in (("pq", KW), ("flat", dict(KW, pq_m=0)),
                     ("sq8", dict(KW, pq_m=0, quantizer="sq8")),
                     ("pq_nores", dict(KW, by_residual=False))):
        j = jb.build_ivf_index(data["train"], data["base"], JParams(**kw))
        out[kind] = (j, to_port(j))
    return out


@pytest.fixture(scope="module")
def probes(data, indexes):
    cent = np.asarray(indexes["pq"][0].centroids)
    d2 = ((data["query"][:, None, :] - cent[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :4].astype(np.int32)


def _assert_scan_equal(got: tscan.ScanResult, ref, rtol, atol):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert got.counts.dtype == torch.int32
    m = got.mask.numpy()
    d_g, d_r = got.distances.numpy(), np.asarray(ref.distances)
    assert (d_g[~m] == np.float32(PAD)).all() and (d_r[~m] >= PAD / 2).all()
    np.testing.assert_allclose(d_g[m], d_r[m], rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_coarse_scan_flat_matches_jax(kind, data, indexes, probes):
    """f32 vectors and the bf16 recon payload: rtol 1e-5 (f32 sums of d
    exact products in another order), atol 0.5 on SIFT-scale distances
    (cancellation in ‖q‖² + ‖x‖² − 2q·x near 0)."""
    j, p = indexes[kind]
    q = data["query"].astype(np.float32)
    payload = "list_recon" if kind == "pq" else "list_vectors"
    ref = jscan.coarse_scan_flat(getattr(j, payload), j.list_ids,
                                 j.list_sizes, jnp.asarray(q),
                                 jnp.asarray(probes), j.list_norms)
    got = tscan.coarse_scan_flat(getattr(p, payload), p.list_ids,
                                 p.list_sizes, t(q), t(probes), p.list_norms)
    _assert_scan_equal(got, ref, rtol=1e-5, atol=0.5)
    # without precomputed norms the scan derives them from the payload
    got2 = tscan.coarse_scan_flat(getattr(p, payload), p.list_ids,
                                  p.list_sizes, t(q), t(probes))
    _assert_scan_equal(got2, ref, rtol=1e-5, atol=0.5)


def test_coarse_scan_sq8_matches_jax(data, indexes, probes):
    j, p = indexes["sq8"]
    q = data["query"].astype(np.float32)
    ref = jscan.coarse_scan_sq8(j.list_sq, j.sq_vmin, j.sq_scale, j.list_ids,
                                j.list_sizes, jnp.asarray(q),
                                jnp.asarray(probes))
    got = tscan.coarse_scan_sq8(p.list_sq, p.sq_vmin, p.sq_scale, p.list_ids,
                                p.list_sizes, t(q), t(probes))
    _assert_scan_equal(got, ref, rtol=1e-5, atol=0.5)


@pytest.mark.parametrize("kind", ["pq", "pq_nores"])
def test_coarse_scan_pq_matches_jax(kind, data, indexes, probes):
    """The LUT is a difference of large terms (‖r‖² + ‖cb‖² − 2⟨r, cb⟩), so
    both sides carry f32 cancellation error: rtol 1e-4, atol 1.0."""
    j, p = indexes[kind]
    q = data["query"].astype(np.float32)
    by_res = j.params.by_residual
    ref = jscan.coarse_scan_pq(j.centroids, j.list_codes, j.list_ids,
                               j.list_sizes, j.codebooks, jnp.asarray(q),
                               jnp.asarray(probes), by_residual=by_res)
    got = tscan.coarse_scan_pq(p.centroids, p.list_codes, p.list_ids,
                               p.list_sizes, p.codebooks, t(q), t(probes),
                               by_residual=by_res)
    _assert_scan_equal(got, ref, rtol=1e-4, atol=1.0)


@pytest.fixture(scope="module")
def pq_views(indexes, probes):
    """{kind: (JAX view, port view, tile_idx, union, pos)} at tile=64."""
    out = {}
    for kind in ("pq", "pq_nores"):
        j, p = indexes[kind]
        jv = j_tiled(j, tile=64, quant="pq")
        tv = t_tiled(p, tile=64, quant="pq")
        tile_idx, _ = tv.expand_probes(probes)
        union, pos = tus.union_probe_tiles(tile_idx, tv.empty_tile)
        out[kind] = (jv, tv, tile_idx, union.astype(np.int32), pos)
    return out


def _pq_args(idx, view, q, union, pos, wrap):
    return (view.payload, view.sizes, wrap(view.tile_list_np), idx.centroids,
            idx.codebooks, wrap(q), wrap(union), wrap(pos))


@pytest.mark.parametrize("kind", ["pq", "pq_nores"])
def test_union_pq_scan_matches_jax(kind, data, indexes, pq_views):
    """The exact f32 ADC over union tiles against the JAX function: same PAD
    lanes; valid lanes rtol 1e-4, atol 1.0 (f32 cancellation in the LUTs)."""
    j, p = indexes[kind]
    jv, tv, _, union, pos = pq_views[kind]
    q = data["query"].astype(np.float32)
    by_res = j.params.by_residual
    ref = np.asarray(jus.union_pq_scan_distances(
        *_pq_args(j, jv, q, union, pos, jnp.asarray), by_residual=by_res))
    got = tus.union_pq_scan_distances(
        *_pq_args(p, tv, q, union, pos, t), by_residual=by_res).numpy()
    assert got.shape == ref.shape
    pad = ref >= PAD / 2
    np.testing.assert_array_equal(got >= PAD / 2, pad)
    np.testing.assert_allclose(got[~pad], ref[~pad], rtol=1e-4, atol=1.0)


def test_union_pq_scan_matches_lut_scan(data, indexes, probes, pq_views):
    """Candidate for candidate against the dense-layout ADC scan
    (coarse_scan_pq), as tests/test_union_scan.py holds the JAX pair:
    within 1e-2 of the distance."""
    _, p = indexes["pq"]
    _, tv, tile_idx, union, pos = pq_views["pq"]
    q = data["query"].astype(np.float32)
    got = tus.union_pq_scan_distances(
        *_pq_args(p, tv, q, union, pos, t)).numpy()
    ref = tscan.coarse_scan_pq(p.centroids, p.list_codes, p.list_ids,
                               p.list_sizes, p.codebooks, t(q), t(probes))
    rd, rid, rm = (ref.distances.numpy(), ref.ids.numpy(), ref.mask.numpy())
    ids_np = tv.tile_ids_np[tile_idx]                  # [nq, mt, T]
    for qi in range(q.shape[0]):
        ref_map = dict(zip(rid[qi][rm[qi]].tolist(), rd[qi][rm[qi]].tolist()))
        ids_row = ids_np[qi].reshape(-1)
        valid = ids_row >= 0
        assert set(ids_row[valid].tolist()) == set(ref_map)
        assert (got[qi][~valid] == np.float32(PAD)).all()
        want = np.array([ref_map[i] for i in ids_row[valid].tolist()])
        np.testing.assert_allclose(got[qi][valid], want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["pq", "pq_nores"])
def test_union_pq_scan_kernel_route_matches_pallas_interpret(
        kind, data, indexes, pq_views):
    """The K3 route (plain version on the CPU, over the probed tiles)
    against the JAX Pallas route (over the union) in interpret mode: same
    PAD lanes, and distances within the f32 error of the table build (the
    bf16 roundings are the same on both sides, but an f32 table entry that
    differs in its last bit can round to the next bf16, 2^-8 of one entry:
    atol 2^-8·max|entry| covers one such flip a lane)."""
    j, p = indexes[kind]
    jv, tv, tile_idx, union, pos = pq_views[kind]
    q = data["query"].astype(np.float32)
    by_res = j.params.by_residual
    ref = np.asarray(jus.union_pq_scan_distances_pallas(
        *_pq_args(j, jv, q, union, pos, jnp.asarray), by_residual=by_res,
        interpret=True))
    calls = k3.pq_probed_distances_plain.calls
    # the K3 route takes each query's own tiles; no union, no positions
    got = tus.union_pq_scan_distances_kernel(
        *_pq_args(p, tv, q, union, pos, t)[:6], t(tile_idx),
        by_residual=by_res).numpy()
    assert k3.pq_probed_distances_plain.calls == calls + 1
    pad = ref >= PAD / 2
    np.testing.assert_array_equal(got >= PAD / 2, pad)
    lut_q, lut_p, _ = tus.pq_luts(p.centroids, p.codebooks, t(q), by_res)
    entry = float(lut_q.abs().max()) + (
        float(lut_p.abs().max()) if lut_p is not None else 0.0)
    err = np.abs(got[~pad] - ref[~pad])
    assert err.max() <= 2.0 ** -8 * entry, (err.max(), entry)
    assert np.median(err) <= 1e-5 * KW["pq_m"] * entry
    # and it stays close to the exact f32 scan (bf16 tables: a few percent)
    exact = tus.union_pq_scan_distances(
        *_pq_args(p, tv, q, union, pos, t), by_residual=by_res).numpy()
    np.testing.assert_allclose(got[~pad], exact[~pad], rtol=0.1,
                               atol=0.02 * entry)
