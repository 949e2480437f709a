"""Port parity: index training, build, npz save/load and the tiled view.

Inputs come from numpy seeds; the JAX package builds the reference index and
the port is held to it (fixture sizes of tests/test_union_scan.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index import build as jb
from prefhetch_tpu.index.tiling import build_tiled_view as j_tiled
from prefhetch_tpu.ops import kmeans as jk
from prefhetch_tpu.ops.union_scan import union_probe_tiles as j_union
from prefhetch_tpu.utils.config import IndexParams as JParams
from prefhetch_tpu_torch.index import build as tb
from prefhetch_tpu_torch.index.tiling import build_tiled_view as t_tiled
from prefhetch_tpu_torch.ops import kmeans as tk
from prefhetch_tpu_torch.ops.union_scan import union_probe_tiles as t_union
from prefhetch_tpu_torch.utils.config import IndexParams as TParams

torch.set_num_threads(1)

KW = dict(d=32, nlist=16, pq_m=8, pq_nbits=8, kmeans_iters=6,
          pq_kmeans_iters=6)


@pytest.fixture(scope="module")
def data():
    return make_clustered_dataset(
        nbase=3000, ntrain=3000, nquery=8, d=32, n_clusters=24, gt_k=10,
        seed=3,
    )


@pytest.fixture(scope="module")
def jax_indexes(data, tmp_path_factory):
    """{kind: (JAX index, its npz path)} for a PQ and a flat index."""
    out = {}
    for kind, kw in (("pq", KW), ("flat", dict(KW, pq_m=0))):
        idx = jb.build_ivf_index(data["train"], data["base"], JParams(**kw))
        path = jb.save_index(idx, str(tmp_path_factory.mktemp(kind)))
        out[kind] = (idx, path)
    return out


@pytest.fixture(params=["pq", "flat"])
def jax_index(request, jax_indexes):
    return (request.param, *jax_indexes[request.param])


def _bits(a) -> np.ndarray:
    """Raw bit pattern of a 2-byte (bf16) array, as uint16."""
    return np.asarray(a).view(np.uint16)


def test_load_jax_npz_bit_equal(jax_index):
    kind, j, path = jax_index
    t = tb.load_index(path, device="cpu")
    assert t.params.artifact_name() == j.params.artifact_name()
    assert t.ntotal == j.ntotal
    for name in ("centroids", "list_ids", "list_sizes", "list_norms"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)), name)
    if kind == "pq":
        np.testing.assert_array_equal(t.list_codes.numpy(),
                                      np.asarray(j.list_codes))
        np.testing.assert_array_equal(t.codebooks.numpy(),
                                      np.asarray(j.codebooks))
        assert t.list_recon.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.list_recon.view(torch.int16).numpy().view(np.uint16),
            _bits(j.list_recon))
    else:
        np.testing.assert_array_equal(t.list_vectors.numpy(),
                                      np.asarray(j.list_vectors))


def test_port_saved_index_loads_in_jax(jax_index, tmp_path):
    kind, j, path = jax_index
    t = tb.load_index(path, device="cpu")
    back = jb.load_index(tb.save_index(t, str(tmp_path)))
    assert back.params == j.params
    fields = ["centroids", "list_ids", "list_sizes", "list_norms"]
    fields += (["list_codes", "codebooks"] if kind == "pq"
               else ["list_vectors"])
    for name in fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(j, name)), name)
    if kind == "pq":
        np.testing.assert_array_equal(_bits(back.list_recon),
                                      _bits(j.list_recon))


def test_index_from_jax_fields_in_memory(jax_index):
    """index_from_numpy takes the JAX index's own fields (bf16 as an
    ml_dtypes array, PQ codes widened to int32) as well as the npz."""
    kind, j, _ = jax_index
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        "centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
        "codebooks", "list_recon", "list_vectors",
    ) if getattr(j, name) is not None}
    t = tb.index_from_numpy(arrays, TParams(**vars(j.params)), device="cpu")
    ref = tb.load_index(jax_index[2], device="cpu")
    payload = "list_recon" if kind == "pq" else "list_vectors"
    assert torch.equal(getattr(t, payload), getattr(ref, payload))
    assert torch.equal(t.list_ids, ref.list_ids)


def test_assign_and_encode_equal_given_same_quantizers(data, jax_indexes):
    j = jax_indexes["pq"][0]
    cents = np.asarray(j.centroids)
    cb = np.asarray(j.codebooks)
    base = data["base"]
    a_j = jb.assign_to_lists(base, cents)
    a_t = tb.assign_to_lists(base, cents, device="cpu")
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(
        tb.encode_pq(base, a_t, cents, cb, TParams(**KW), device="cpu"),
        jb.encode_pq(base, a_j, cents, cb, JParams(**KW)),
    )
    np.testing.assert_array_equal(
        tb.assign_to_lists_balanced(base, cents, device="cpu"),
        jb.assign_to_lists_balanced(base, cents),
    )


def test_one_lloyd_iteration_matches(data):
    """From the same init (drawn by the same host rng) one Lloyd iteration
    gives the same centroids: rtol 1e-5 (f32 sums in another order; on
    integer SIFT-style data they are exact)."""
    x = data["train"]
    for spherical in (False, True):
        j = jk.train_kmeans(x, k=16, iters=1, seed=5, spherical=spherical)
        t = tk.train_kmeans(x, k=16, iters=1, seed=5, spherical=spherical,
                            device="cpu")
        np.testing.assert_allclose(t, j, rtol=1e-5)
    sub = x.reshape(x.shape[0], 8, 4).transpose(1, 0, 2)
    j = jk.train_kmeans_batched(sub, k=32, iters=1, seed=5)
    t = tk.train_kmeans_batched(sub, k=32, iters=1, seed=5, device="cpu")
    np.testing.assert_allclose(t, j, rtol=1e-5)


def test_empty_cluster_repair_matches():
    """Duplicate points force empty clusters: the repair (perturbed copies
    of the largest cluster's centroid) follows the JAX package's rule."""
    x = np.repeat(np.arange(6, dtype=np.float32)[:, None], 4, axis=1)
    x = np.repeat(x, 5, axis=0)                 # 6 distinct points x5
    init = np.concatenate([x[:1].repeat(3, 0), x[5:6], x[10:11]])
    xc, vc = jk._pad_chunks(x, 8)
    j, _ = jk._kmeans_loop(jnp.asarray(xc), jnp.asarray(vc),
                           jnp.asarray(init), 5, 2)
    t = tk.lloyd_iterations(torch.from_numpy(x), torch.from_numpy(init), 2,
                            chunk=8)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_tiled_view_tables_equal(jax_index):
    kind, j, path = jax_index
    jv = j_tiled(j, tile=64)
    tv = t_tiled(tb.load_index(path, device="cpu"), tile=64)
    for name in ("tile_ids_np", "tile_sizes_np", "tile_start_np",
                 "tile_count_np", "tile_list_np"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      name)
    assert tv.empty_tile == jv.empty_tile
    np.testing.assert_array_equal(tv.norms.numpy(), np.asarray(jv.norms))
    np.testing.assert_array_equal(tv.sizes.numpy(), np.asarray(jv.sizes))
    np.testing.assert_array_equal(tv.ids.numpy(), np.asarray(jv.ids))
    if kind == "pq":
        np.testing.assert_array_equal(
            tv.payload.view(torch.int16).numpy().view(np.uint16),
            _bits(jv.payload))
    else:
        np.testing.assert_array_equal(tv.payload.numpy(),
                                      np.asarray(jv.payload))
    probes = np.array([[0, 3, 5], [15, 2, 2]])
    for got, ref in zip(tv.expand_probes(probes, min_t=9),
                        jv.expand_probes(probes, min_t=9)):
        np.testing.assert_array_equal(got, ref)
    assert tv.serving_max_tiles(3) == jv.serving_max_tiles(3)


HOLE = 5                    # the list emptied in the holed indexes
INDEX_FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms",
                "list_codes", "codebooks", "list_recon", "list_vectors")


@pytest.fixture(scope="module")
def holed(jax_indexes):
    """{kind: (JAX index, port index)} with list HOLE emptied, so that a
    probe can name a list of zero tiles."""
    out = {}
    for kind, (j, _) in jax_indexes.items():
        sizes = np.asarray(j.list_sizes).copy()
        sizes[HOLE] = 0
        arrays = {f: np.array(getattr(j, f)) for f in INDEX_FIELDS
                  if getattr(j, f) is not None}
        arrays["list_sizes"] = sizes
        kw = dict(KW, pq_m=0) if kind == "flat" else KW
        out[kind] = (
            j.replace(list_sizes=jnp.asarray(sizes), host_arrays=None),
            tb.index_from_numpy(arrays, TParams(**kw), device="cpu"))
    return out


def _probe_case(name, counts, rng):
    """(probes [nq, nprobe], bucket, min_t) of one expansion case over a view
    whose lists hold ``counts`` tiles."""
    nlist = len(counts)
    if name == "duplicates":        # a probe repeated within a row
        p = rng.integers(0, nlist, (8, 4))
        p[:, 1] = p[:, 0]
        p[0] = p[0, 0]
        return p, 8, None
    if name == "empty_list":        # a probed list of zero tiles
        p = rng.integers(0, nlist, (8, 4))
        p[:, 2] = HOLE
        p[1] = HOLE
        return p, 8, None
    if name in ("min_t_above", "min_t_below"):
        p = rng.integers(0, nlist, (8, 4))
        top = int(counts[p].sum(1).max())
        return p, 8, top + 13 if name == "min_t_above" else 1
    if name in ("bucket_1", "bucket_8"):
        return rng.integers(0, nlist, (8, 4)), int(name[-1]), None
    if name in ("nq_1", "nq_64"):
        return rng.integers(0, nlist, (int(name[3:]), 4)), 8, None
    if name == "fills_max_t":       # every row its batch's max, bucket 1
        return np.tile(rng.permutation(nlist)[:4], (8, 1)), 1, None
    assert name == "largest_lists"  # the lists serving_max_tiles sums
    big = np.argsort(counts, kind="stable")[::-1][:4]
    return np.tile(big, (8, 1)), 8, None


@pytest.mark.parametrize("name", [
    "duplicates", "empty_list", "min_t_above", "min_t_below", "bucket_1",
    "bucket_8", "nq_1", "nq_64", "fills_max_t", "largest_lists",
])
def test_expand_probes_and_union_equal_jax(name, holed):
    """The table-driven probe expansion and the rank-table union: tile ids,
    candidate counts, union and positions element-equal (dtypes too) to the
    JAX package's loop and np.unique, on a view with an empty list."""
    j, t = holed["pq"]
    jv, tv = j_tiled(j, tile=64), t_tiled(t, tile=64)
    assert tv.tile_count_np[HOLE] == 0
    probes, bucket, min_t = _probe_case(
        name, tv.tile_count_np, np.random.default_rng(len(name)))
    if name == "largest_lists":
        min_t = tv.serving_max_tiles(4, bucket)
    got = tv.expand_probes(probes, bucket=bucket, min_t=min_t)
    ref = jv.expand_probes(probes, bucket=bucket, min_t=min_t)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    tile_idx = got[0]
    if name == "fills_max_t":
        assert tv.empty_tile not in tile_idx
    if name == "largest_lists":
        assert tile_idx.shape[1] == min_t == jv.serving_max_tiles(4, bucket)
    union, pos = t_union(tile_idx, tv.empty_tile)
    j_u, j_p = j_union(ref[0], jv.empty_tile)
    assert union.dtype == j_u.dtype and pos.dtype == j_p.dtype
    np.testing.assert_array_equal(union, j_u)
    np.testing.assert_array_equal(pos, j_p)
    n_real = len(np.unique(tile_idx[tile_idx != tv.empty_tile]))
    assert union[n_real] == tv.empty_tile and len(union) % 128 == 0
    np.testing.assert_array_equal(union[pos], tile_idx)


@pytest.mark.parametrize("kind,quant", [
    ("pq", "none"), ("flat", "none"), ("pq", "sq8"), ("pq", "pq"),
])
def test_list_tiles_table(kind, quant, holed):
    """Row c of list_tiles_np is list c's tiles in order, padded with the
    empty tile, for the bf16, f32, SQ8 and PQ-code payloads."""
    tv = t_tiled(holed[kind][1], tile=64, quant=quant)
    lt = tv.list_tiles_np
    assert lt.dtype == np.int32
    assert lt.shape == (len(tv.tile_count_np), tv.tile_count_np.max())
    for c, (s, n) in enumerate(zip(tv.tile_start_np, tv.tile_count_np)):
        want = np.full(lt.shape[1], tv.empty_tile, np.int32)
        want[:n] = np.arange(s, s + n)
        np.testing.assert_array_equal(lt[c], want)
    assert (lt[HOLE] == tv.empty_tile).all()


def test_build_ivf_index_matches_jax(data, jax_indexes):
    """The port's full build (k-means, assignment, PQ training, encoding,
    bf16 recon) on the same data and the same rng draws. The coarse
    quantizer trains on integer data and lands on the JAX package's
    centroids (rtol 1e-5: f32 sums in another order) and the same lists.
    The PQ k-means runs on non-integer residuals, where a point equidistant
    to two codewords within f32 rounding may flip and move a codeword, so
    codebooks and codes are held to agree on nearly all entries, not all."""
    j = jax_indexes["pq"][0]
    t = tb.build_ivf_index(data["train"], data["base"], TParams(**KW),
                           device="cpu")
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=1e-5)
    np.testing.assert_array_equal(t.list_sizes.numpy(),
                                  np.asarray(j.list_sizes))
    np.testing.assert_array_equal(t.list_ids.numpy(), np.asarray(j.list_ids))
    cb_close = np.isclose(t.codebooks.numpy(), np.asarray(j.codebooks),
                          rtol=1e-5, atol=1e-4).all(-1)
    assert cb_close.mean() > 0.95, cb_close.mean()
    codes_eq = t.list_codes.numpy() == np.asarray(j.list_codes)
    assert codes_eq.mean() > 0.95, codes_eq.mean()


def test_build_sq8_index_matches_jax(data):
    """The SQ8 quantizer trains min and scale on the train set in numpy on
    both sides: bit-equal parameters, and bit-equal codes given the same
    lists (the coarse k-means lands on the same assignment, as above)."""
    kw = dict(KW, pq_m=0, quantizer="sq8")
    j = jb.build_ivf_index(data["train"], data["base"], JParams(**kw))
    t = tb.build_ivf_index(data["train"], data["base"], TParams(**kw),
                           device="cpu")
    assert "SQ8" in t.params.artifact_name()
    assert t.list_sq.dtype == torch.uint8 and t.list_codes is None
    np.testing.assert_array_equal(t.list_ids.numpy(), np.asarray(j.list_ids))
    for name in ("sq_vmin", "sq_scale", "list_sq"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


@pytest.mark.parametrize("kind,quant", [
    ("pq", "sq8"), ("flat", "sq8"), ("pq", "pq"),
])
def test_quantised_tiled_views_bit_equal(kind, quant, jax_indexes):
    """The SQ8 view (quantised from the bf16 recon or the f32 vectors, pad
    rows included) and the PQ-codes view: every table, the payload bytes, the
    decoded-value norms and the affine bit-equal to the JAX view's."""
    j, path = jax_indexes[kind]
    jv = j_tiled(j, tile=64, quant=quant)
    tv = t_tiled(tb.load_index(path, device="cpu"), tile=64, quant=quant)
    for name in ("tile_ids_np", "tile_sizes_np", "tile_start_np",
                 "tile_count_np", "tile_list_np"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      name)
    assert tv.empty_tile == jv.empty_tile and tv.tile == jv.tile
    assert tv.payload.dtype == torch.uint8
    assert tv.payload.shape[2] == (KW["pq_m"] if quant == "pq" else KW["d"])
    np.testing.assert_array_equal(tv.payload.numpy(), np.asarray(jv.payload))
    np.testing.assert_array_equal(tv.norms.numpy(), np.asarray(jv.norms))
    np.testing.assert_array_equal(tv.sizes.numpy(), np.asarray(jv.sizes))
    np.testing.assert_array_equal(tv.ids.numpy(), np.asarray(jv.ids))
    if quant == "sq8":
        np.testing.assert_array_equal(tv.sq_vmin.numpy(),
                                      np.asarray(jv.sq_vmin))
        np.testing.assert_array_equal(tv.sq_scale.numpy(),
                                      np.asarray(jv.sq_scale))
    else:
        assert tv.sq_vmin is None and tv.sq_scale is None
        assert not tv.norms.any()


def test_tiled_view_refuses_what_it_cannot_build(jax_indexes):
    flat = tb.load_index(jax_indexes["flat"][1], device="cpu")
    assert t_tiled(flat, tile=64, quant="pq") is None      # no codes
    with pytest.raises(ValueError, match="unknown quant"):
        t_tiled(flat, tile=64, quant="int4")
