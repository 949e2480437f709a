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
from prefhetch_tpu.utils.config import IndexParams as JParams
from prefhetch_tpu_torch.index import build as tb
from prefhetch_tpu_torch.index.tiling import build_tiled_view as t_tiled
from prefhetch_tpu_torch.ops import kmeans as tk
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
