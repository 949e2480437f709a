"""Port parity: the model families (FlatL2, IVFFlat, IVFPQ, IVFSQ8), the SQ8
quantizer of the index build and its npz fields, and the coarse-leakage
analysis — the counterparts of tests/test_model_families.py, held to the JAX
package on the same data."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prefhetch_tpu import models as jm
from prefhetch_tpu.analysis import measure_coarse_leakage as j_leakage
from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index import build as jb
from prefhetch_tpu.ops.distances import rank_centroids as j_rank
from prefhetch_tpu.utils.config import IndexParams as JParams
from prefhetch_tpu_torch import models as tm
from prefhetch_tpu_torch.analysis import measure_coarse_leakage as t_leakage
from prefhetch_tpu_torch.index import build as tb
from prefhetch_tpu_torch.utils.config import IndexParams as TParams

torch.set_num_threads(1)

FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors", "list_sq", "sq_vmin",
          "sq_scale")
P = dict(d=32, nlist=16, kmeans_iters=8)


@pytest.fixture(scope="module")
def data():
    return make_clustered_dataset(
        nbase=2000, ntrain=4000, nquery=20, d=32, n_clusters=40, gt_k=50,
        seed=7,
    )


def _port_model(cls, jmodel):
    """A port model holding the JAX model's index (its fields, via
    index_from_numpy), on the CPU."""
    j = jmodel.index
    arrays = {f: np.asarray(getattr(j, f)) for f in FIELDS
              if getattr(j, f) is not None}
    params = TParams(**vars(j.params))
    m = cls(params, device="cpu")
    m.index = tb.index_from_numpy(arrays, params, device="cpu")
    m.nprobe = jmodel.nprobe
    return m


@pytest.fixture(scope="module")
def jax_models(data):
    out = {}
    for name, cls, kw in (
        ("flat", jm.IVFFlat, dict(pq_m=0, **P)),
        ("sq8", jm.IVFSQ8, dict(pq_m=0, quantizer="sq8", **P)),
        ("pq", jm.IVFPQ, dict(pq_m=8, pq_kmeans_iters=8, **P)),
    ):
        m = cls(JParams(**kw))
        m.train_add(data["train"], data["base"])
        m.nprobe = 8
        out[name] = m
    return out


def _assert_same_search(d_t, i_t, d_j, i_j, rtol, atol):
    """Distances close; ids equal wherever a distance is not (nearly) tied
    with a neighbour of its row."""
    np.testing.assert_allclose(d_t, d_j, rtol=rtol, atol=atol)
    gap = np.abs(np.diff(d_j, axis=1))
    tied = np.zeros_like(d_j, bool)
    near = gap <= 2 * (atol + rtol * np.abs(d_j[:, 1:]))
    tied[:, 1:] |= near
    tied[:, :-1] |= near
    np.testing.assert_array_equal(i_t[~tied], i_j[~tied])


@pytest.mark.parametrize("name,cls", [
    ("flat", tm.IVFFlat), ("sq8", tm.IVFSQ8), ("pq", tm.IVFPQ),
])
def test_model_search_matches_jax(name, cls, data, jax_models):
    """search() on the JAX model's own index: rtol 1e-5 / atol 0.5 (f32 sums
    in another order on SIFT-scale distances)."""
    j = jax_models[name]
    t = _port_model(cls, j)
    assert t.is_trained and t.ntotal == j.ntotal == 2000
    np.testing.assert_array_equal(t.reconstruct_centroids(),
                                  j.reconstruct_centroids())
    for kw in (dict(k=10), dict(k=10, coarse_probe=50)):
        d_j, i_j = j.search(data["query"], **kw)
        d_t, i_t = t.search(data["query"], **kw)
        assert d_t.shape == (20, 10) and i_t.dtype == np.int32
        _assert_same_search(d_t, i_t, d_j, i_j, rtol=1e-5, atol=0.5)


def test_ivfpq_without_recon_takes_the_lut_scan(data, jax_models):
    """An IVF-PQ index without the dense reconstruction scans by LUT."""
    j = jax_models["pq"]
    t = _port_model(tm.IVFPQ, j)
    t.index.list_recon = None
    q = data["query"][:4]
    _, probe = j_rank(jnp.asarray(q), j.index.centroids, 4)
    from prefhetch_tpu.ops.scan import coarse_scan_pq

    ref = coarse_scan_pq(j.index.centroids, j.index.list_codes,
                         j.index.list_ids, j.index.list_sizes,
                         j.index.codebooks, jnp.asarray(q), probe)
    got = t.coarse_scan(q, np.asarray(probe))
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_allclose(got.distances.numpy()[m],
                               np.asarray(ref.distances)[m], rtol=1e-4,
                               atol=1.0)
    with pytest.raises(ValueError, match="pq_m > 0"):
        tm.IVFPQ(TParams(pq_m=0, **P), device="cpu")


def test_flat_l2_matches_jax(data):
    j, t = jm.FlatL2(32), tm.FlatL2(32, device="cpu")
    for m in (j, t):
        m.add(data["base"][:700])
        m.add(data["base"][700:1500])
    assert t.ntotal == j.ntotal == 1500
    d_j, i_j = j.search(data["query"], 10)
    d_t, i_t = t.search(data["query"], 10)
    _assert_same_search(d_t, i_t, d_j, i_j, rtol=1e-5, atol=0.5)
    np.testing.assert_array_equal(t.reconstruct(7), j.reconstruct(7))
    # integer data: the best hit is the exact nearest neighbour
    np.testing.assert_array_equal(
        i_t[:, 0], np.argmin(((data["base"][None, :1500] - data["query"][
            :, None]) ** 2).sum(-1), axis=1))


def test_sq8_recall_close_to_flat(data):
    """The port trains and searches on its own (device='cpu')."""
    flat = tm.IVFFlat(TParams(pq_m=0, **P), device="cpu")
    flat.train_add(data["train"], data["base"])
    flat.nprobe = 8
    _, flat_ids = flat.search(data["query"], k=10)
    sq = tm.IVFSQ8(TParams(pq_m=0, quantizer="sq8", **P), device="cpu")
    sq.train_add(data["train"], data["base"])
    sq.nprobe = 8
    _, sq_ids = sq.search(data["query"], k=10)
    gt1 = data["groundtruth"][:, 0]
    flat_hit = (flat_ids == gt1[:, None]).any(axis=1).mean()
    sq_hit = (sq_ids == gt1[:, None]).any(axis=1).mean()
    assert flat_hit > 0.8
    assert sq_hit >= flat_hit - 0.1  # 8-bit loss must be tiny at SIFT scale


def test_sq8_distance_accuracy(data):
    sq = tm.IVFSQ8(TParams(d=32, nlist=16, quantizer="sq8", kmeans_iters=8),
                   device="cpu")
    assert sq.params.uses_sq8 and not sq.params.uses_pq
    sq.train_add(data["train"], data["base"])
    q = data["query"][:2]
    cents = sq.reconstruct_centroids()
    probe = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                       kind="stable")[:, :4]
    res = sq.coarse_scan(q, probe)
    mask, ids, dist = (res.mask.numpy(), res.ids.numpy(),
                       res.distances.numpy())
    assert (res.counts.numpy() == mask.sum(1)).all()
    for qi in range(2):
        v = np.where(mask[qi])[0][:100]
        exact = ((data["base"][ids[qi, v]] - q[qi]) ** 2).sum(-1)
        # 8-bit quantization error: small relative to SIFT-scale distances
        np.testing.assert_allclose(dist[qi, v], exact, rtol=0.02, atol=100.0)


def test_sq8_save_load(tmp_path, data):
    sq = tm.IVFSQ8(TParams(d=32, nlist=8, quantizer="sq8", kmeans_iters=5),
                   device="cpu")
    sq.train_add(data["train"][:1000], data["base"][:500])
    p = sq.save(str(tmp_path))
    assert "SQ8" in p
    sq2 = tm.IVFSQ8.load(p, device="cpu")
    assert sq2.params == sq.params and sq2.ntotal == 500
    for f in ("list_sq", "sq_vmin", "sq_scale", "list_ids", "list_sizes"):
        assert torch.equal(getattr(sq.index, f), getattr(sq2.index, f)), f
    with pytest.raises(RuntimeError, match="not trained"):
        tm.IVFSQ8(device="cpu", d=32).save(str(tmp_path))


def test_sq8_npz_loads_in_the_other_package(tmp_path, data, jax_models):
    """An SQ8 npz saved by either package, loaded by the other: every field
    bit-equal."""
    j = jax_models["sq8"]
    t = tm.IVFSQ8.load(j.save(str(tmp_path / "j")), device="cpu")
    fields = ("centroids", "list_ids", "list_sizes", "list_sq", "sq_vmin",
              "sq_scale")
    for f in fields:
        np.testing.assert_array_equal(getattr(t.index, f).numpy(),
                                      np.asarray(getattr(j.index, f)), f)
    assert t.index.list_sq.dtype == torch.uint8
    assert t.index.list_vectors is None and not t.index.uses_pq
    back = jm.IVFSQ8.load(t.save(str(tmp_path / "t")))
    assert back.params == j.params
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(back.index, f)),
                                      np.asarray(getattr(j.index, f)), f)


def test_sq8_quantizer_bit_equal_given_the_same_lists(data, jax_models):
    """The SQ8 branch of the port's own build: min and scale come from the
    train set in numpy as in the JAX package, so with the same coarse
    quantizer (integer data: the same lists) the codes are bit-equal."""
    j = jax_models["sq8"].index
    t = tb.build_ivf_index(data["train"], data["base"],
                           TParams(pq_m=0, quantizer="sq8", **P),
                           device="cpu")
    np.testing.assert_array_equal(t.list_ids.numpy(), np.asarray(j.list_ids))
    np.testing.assert_array_equal(t.sq_vmin.numpy(), np.asarray(j.sq_vmin))
    np.testing.assert_array_equal(t.sq_scale.numpy(), np.asarray(j.sq_scale))
    np.testing.assert_array_equal(t.list_sq.numpy(), np.asarray(j.list_sq))
    assert t.list_norms is None and t.list_vectors is None


def test_rerank_exact_matches_jax(data):
    rng = np.random.default_rng(5)
    cand = rng.integers(0, 2000, (20, 30))
    ref = jm.ivf.rerank_exact(data["base"], data["query"], cand)
    got = tm.rerank_exact(data["base"], data["query"], cand, device="cpu")
    np.testing.assert_array_equal(got, ref)       # integer data: exact


def test_models_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tm.FlatL2(8), lambda: tm.IVFFlat(d=8),
                 lambda: tm.IVFSQ8(d=8), lambda: tm.IVFPQ(d=8, pq_m=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.rerank_exact(np.zeros((4, 8)), np.zeros((1, 8)),
                        np.zeros((1, 2), np.int64))


def test_coarse_leakage_matches_jax(data, jax_models):
    """The numpy-only analysis copy on the port's index gives the JAX
    package's report."""
    j = jax_models["pq"]
    t = _port_model(tm.IVFPQ, j)
    base, q = data["base"][:800], data["query"][:10]
    rj = j_leakage(j.index, base, q)
    rt = t_leakage(t.index, base, q)
    assert rt.nq == rj.nq == 10 and rt.code_bits == rj.code_bits == 64
    for name in ("codes", "probes"):
        assert vars(rt.adversaries[name]) == vars(rj.adversaries[name])
    assert rt.summary() == rj.summary()
