"""K3 in its probed form (ops/pq_onehot.pq_probed_distances) on the CPU.

Its plain version against the JAX package's PQ scan stage
(union_pq_scan_distances_pallas, Pallas in interpret mode), against the
union composition that defines it at edge shapes (bit-equal), one lane
spelled out from the contract, the wrapper's refusals, and
query_pipeline(quant="pq") without a union against the JAX composition of
bench.py tpu_pipeline. The card's kernel is held against the same plain
version in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.index import build as jb
from prefhetch_tpu.index.tiling import build_tiled_view as j_tiled
from prefhetch_tpu.ops import union_scan as jus
from prefhetch_tpu.ops.distances import rank_centroids as j_rank
from prefhetch_tpu.ops.rerank import exact_rerank as j_rerank
from prefhetch_tpu.ops.topk import PAD_DISTANCE as J_PAD
from prefhetch_tpu.ops.topk import topk_select_segmented as j_topk_seg
from prefhetch_tpu.utils.config import IndexParams as JParams
from prefhetch_tpu_torch import pipeline as tp
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.index.tiling import build_tiled_view as t_tiled
from prefhetch_tpu_torch.ops import pq_onehot as k3
from prefhetch_tpu_torch.ops import union_scan as tus
from prefhetch_tpu_torch.utils.config import IndexParams as TParams

torch.set_num_threads(1)

PAD = 3.4e38
KW = dict(d=32, nlist=16, pq_m=8, pq_nbits=8, kmeans_iters=6,
          pq_kmeans_iters=6)
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")
NPROBE, COARSE_PROBE, K = 6, 48, 10
EMPTY = 9                               # the reserved empty tile of _case


def t(a, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


# -- synthetic tables and tiles with every edge ----------------------------------

def _case(T, M, ksub, nq, max_t, zero_p, seed):
    """Ten tiles of sizes T, 1, T−1, 0, T//2, ... and the empty tile 9 (size
    0); four lists; probe rows that mix them, row 0 opening with the tiles
    of sizes T, 1, T−1, 0 and (for nq > 1) a last row of nothing but the
    empty tile; cadd spread so that some sums clamp at 0."""
    rng = np.random.default_rng(seed)
    nlist = 4
    sizes = np.array([T, 1, T - 1, 0, T // 2, T, min(3, T), T, min(2, T), 0],
                     np.int32)
    codes = rng.integers(0, ksub, (EMPTY + 1, T, M)).astype(np.uint8)
    codes[EMPTY] = 0
    lutq = (rng.normal(size=(nq, M * ksub)) * 3000).astype(np.float32)
    lutp = np.zeros((nlist, M * ksub), np.float32) if zero_p else \
        (rng.normal(size=(nlist, M * ksub)) * 700).astype(np.float32)
    cadd = (rng.normal(size=(nq, nlist)) * 3000 * M ** 0.5).astype(np.float32)
    tile_list = np.sort(rng.integers(0, nlist, EMPTY + 1)).astype(np.int32)
    tiles = rng.integers(0, EMPTY + 1, (nq, max_t)).astype(np.int32)
    head = min(4, max_t)
    tiles[0, :head] = np.arange(head)
    if nq > 1:
        tiles[-1] = EMPTY
    return codes, lutq, lutp, cadd, sizes, tile_list, tiles


EDGES = [
    # T, M, ksub, nq, max_t, zero lutp
    (256, 32, 256, 13, 6, False),       # the operating point's widths
    (100, 8, 256, 5, 4, False),         # M = 8: byte-wise code loads
    (64, 200, 256, 3, 3, False),        # M = 200: a 100 KB table
    (64, 16, 64, 3, 5, True),           # ksub = 64; by_residual=False
    (32, 16, 256, 1, 3, False),         # one query
    (16, 32, 256, 70, 2, False),        # 70 queries
    (64, 32, 256, 6, 1, False),         # one probe slot
]


@pytest.mark.parametrize("T,M,ksub,nq,max_t,zero_p", EDGES)
def test_pq_probed_equals_union_composition(T, M, ksub, nq, max_t, zero_p):
    """The probed function is the union form over the union of the probed
    tiles, then the scalar, clamp, mask and extraction: bit-equal, with the
    union built as the JAX stage builds it (padded with the empty tile)."""
    codes, lutq, lutp, cadd, sizes, tile_list, tiles = _case(
        T, M, ksub, nq, max_t, zero_p, seed=T + M + nq + max_t)
    union, pos = tus.union_probe_tiles(tiles, EMPTY)
    part = k3.pq_onehot_distances_plain(t(codes), t(lutq), t(lutp),
                                        t(tile_list), t(union))
    want = k3.pq_finish(part.reshape(nq, -1, T), t(cadd), t(sizes),
                        t(tile_list), t(union), t(pos))
    calls = k3.pq_probed_distances_plain.calls
    got = k3.pq_probed_distances(t(codes), t(lutq), t(lutp), t(cadd),
                                 t(sizes), t(tile_list), t(tiles))
    assert k3.pq_probed_distances_plain.calls == calls + 1
    assert k3.pq_probed_distances.launches == 0
    assert got.dtype == torch.float32 and got.shape == (nq, max_t * T)
    assert torch.equal(got, want)
    g = got.numpy().reshape(nq, max_t, T)
    valid = np.arange(T)[None, None, :] < sizes[tiles][:, :, None]
    assert (g[~valid] == np.float32(PAD)).all()
    assert (g[valid] >= 0).all()
    if nq > 1:
        assert (g[-1] == np.float32(PAD)).all()    # the all-empty probe row


def test_pq_probed_one_lane_from_the_contract():
    """out[q, s·T + t] = max(cadd[q, L] + Σ_m bf16(bf16(lutq[q]) +
    bf16(lutp[L]))[m·ksub + code], 0) for t < size, PAD past it."""
    T, M, ksub, nq = 64, 16, 256, 3
    codes, lutq, lutp, cadd, sizes, tile_list, tiles = _case(
        T, M, ksub, nq, 5, False, seed=5)
    L2 = tile_list[tiles[0, 2]]
    cadd[0, L2] = -1e9                  # every lane of slot 2 clamps to 0
    got = k3.pq_probed_distances(t(codes), t(lutq), t(lutp), t(cadd),
                                 t(sizes), t(tile_list), t(tiles)).numpy()
    for s in (0, 1):                    # tiles 0 (size T) and 1 (size 1)
        tile = tiles[0, s]
        L = tile_list[tile]
        lut = (t(lutq, torch.bfloat16)[0]
               + t(lutp, torch.bfloat16)[L]).float().numpy().astype(np.float64)
        terms = lut[np.arange(M) * ksub + codes[tile, :, :].astype(np.int64)]
        want = np.maximum(cadd[0, L] + terms.sum(-1), 0.0)     # [T]
        lane = got[0, s * T:(s + 1) * T]
        n = sizes[tile]
        np.testing.assert_allclose(lane[:n], want[:n], rtol=1e-6,
                                   atol=1e-6 * np.abs(terms).sum(-1).max())
        assert (lane[n:] == np.float32(PAD)).all()
    assert (got[0, 2 * T:2 * T + sizes[tiles[0, 2]]] == 0.0).all()
    assert (got[0, 3 * T:4 * T] == np.float32(PAD)).all()     # size 0


def _good():
    codes = torch.zeros((3, 8, 4), dtype=torch.uint8)
    return dict(codes=codes, lutq=torch.zeros((2, 64)),
                lutp=torch.zeros((5, 64)), cadd=torch.zeros((2, 5)),
                sizes=torch.zeros(3, dtype=torch.int32),
                tile_list=torch.zeros(3, dtype=torch.int32),
                tiles=torch.zeros((2, 4), dtype=torch.int32))


REFUSALS = [
    ("codes", lambda a: a.int(), "uint8"),
    ("codes", lambda a: a.transpose(1, 2), "contiguous uint8"),
    ("lutq", lambda a: a[:, :62], "lutq must"),
    ("lutq", lambda a: a.half(), "f32 or bf16"),
    ("lutp", lambda a: a[:, :32], "lutp must"),
    ("lutp", lambda a: a.double(), "f32 or bf16"),
    ("cadd", lambda a: a[:, :4], "cadd must"),
    ("cadd", lambda a: a.double(), "cadd must"),
    ("sizes", lambda a: a.long(), "sizes must"),
    ("tile_list", lambda a: a[:2], "tile_list must"),
    ("tiles", lambda a: a.long(), "tiles must"),
    ("tiles", lambda a: a[:1], "tiles must"),
    ("tiles", lambda a: a[:, :0], "tiles must"),
    ("tiles", lambda a: a.to("meta"), "is on"),
]


@pytest.mark.parametrize("name,bad,match", REFUSALS,
                         ids=[f"{r[0]}-{r[2]}" for r in REFUSALS])
def test_pq_probed_refuses_what_the_kernel_cannot_take(name, bad, match):
    args = _good()
    k3._check(**args)                   # the good case passes
    args[name] = bad(args[name])
    with pytest.raises(ValueError, match=match):
        k3._check(**args)


def test_pq_probed_refuses_tables_past_shared_memory_and_other_devices():
    args = _good()
    args["codes"] = torch.zeros((3, 8, 512), dtype=torch.uint8)
    args["lutq"] = torch.zeros((2, 512 * 256))
    args["lutp"] = torch.zeros((5, 512 * 256))
    with pytest.raises(ValueError, match="exceeds the shared"):
        k3._check(**args)
    with pytest.raises(ValueError, match="256 codewords"):
        k3._check(**dict(_good(), lutq=torch.zeros((2, 4 * 257)),
                         lutp=torch.zeros((5, 4 * 257))))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k3.pq_probed_distances(*(a.to("meta") for a in _good().values()))


# -- on built indexes: the JAX stage and the JAX pipeline ---------------------------

@pytest.fixture(scope="module")
def data():
    return make_clustered_dataset(
        nbase=3000, ntrain=3000, nquery=9, d=32, n_clusters=24, gt_k=10,
        seed=3,
    )


@pytest.fixture(scope="module")
def indexes(data):
    """{kind: (JAX index, the port's index from its fields)}."""
    out = {}
    for kind, kw in (("pq", KW), ("pq_nores", dict(KW, by_residual=False))):
        j = jb.build_ivf_index(data["train"], data["base"], JParams(**kw))
        arrays = {f: np.asarray(getattr(j, f)) for f in FIELDS
                  if getattr(j, f) is not None}
        out[kind] = (j, index_from_numpy(arrays, TParams(**vars(j.params)),
                                         device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["pq", "pq_nores"])
def test_pq_probed_matches_pallas_stage(kind, data, indexes):
    """pq_probed_distances, given bf16 tables, against the JAX package's pq
    scan stage (union scoring on the Pallas kernel in interpret mode, then
    its epilogue and extraction), at tile 32: same PAD lanes; distances
    within one bf16 flip of a table entry (tests/test_torch_scan.py's
    tolerance for the same route)."""
    j, p = indexes[kind]
    by_res = bool(j.params.by_residual)
    q = data["query"].astype(np.float32)
    probes = np.argsort(((q[:, None] - np.asarray(j.centroids)[None]) ** 2)
                        .sum(-1), axis=1, kind="stable")[:, :4]
    jv = j_tiled(j, tile=32, quant="pq")
    tv = t_tiled(p, tile=32, quant="pq")
    tiles, _ = tv.expand_probes(probes)
    union, pos = jus.union_probe_tiles(tiles, jv.empty_tile)
    ref = np.asarray(jus.union_pq_scan_distances_pallas(
        jv.payload, jv.sizes, jnp.asarray(jv.tile_list_np), j.centroids,
        j.codebooks, jnp.asarray(q), jnp.asarray(union), jnp.asarray(pos),
        by_residual=by_res, interpret=True))
    lut_q, lut_p, cadd = tus.pq_luts(p.centroids, p.codebooks, t(q), by_res)
    if lut_p is None:
        lut_p = torch.zeros((p.centroids.shape[0], lut_q.shape[1]))
    got = k3.pq_probed_distances(
        tv.payload, lut_q.to(torch.bfloat16), lut_p.to(torch.bfloat16), cadd,
        tv.sizes, t(tv.tile_list_np), t(tiles)).numpy()
    assert got.shape == ref.shape
    pad = ref >= PAD / 2
    np.testing.assert_array_equal(got >= PAD / 2, pad)
    entry = float(lut_q.abs().max()) + float(lut_p.abs().max())
    err = np.abs(got[~pad] - ref[~pad])
    assert err.max() <= 2.0 ** -8 * entry, (err.max(), entry)
    assert np.median(err) <= 1e-5 * KW["pq_m"] * entry


def _jax_pq_pipeline(index, base, queries, tile):
    """bench.py tpu_pipeline's quant="pq" composition (union scan on the
    Pallas kernel in interpret mode, then top-k, id resolve, exact re-rank,
    final top-k). Returns (distances [nq, K], ids [nq, K])."""
    view = j_tiled(index, tile=tile, quant="pq")
    T = view.tile
    q = jnp.asarray(queries)
    _, probes = j_rank(q, index.centroids, NPROBE)
    tiles_np, _ = view.expand_probes(np.asarray(probes))
    union_np, pos_np = jus.union_probe_tiles(tiles_np, view.empty_tile)
    dist = jus.union_pq_scan_distances_pallas(
        view.payload, view.sizes, jnp.asarray(view.tile_list_np),
        index.centroids, index.codebooks, q, jnp.asarray(union_np),
        jnp.asarray(pos_np), by_residual=bool(index.params.by_residual),
        interpret=True)
    _, pos = j_topk_seg(dist, COARSE_PROBE, tiles_np.shape[1],
                        level1_bf16=True)
    tiles = jnp.asarray(tiles_np)
    cand = view.ids[jnp.take_along_axis(tiles, pos // T, axis=1), pos % T]
    pad = cand < 0
    cand = jnp.maximum(cand, 0)
    pd = jnp.where(pad, J_PAD, j_rerank(jnp.asarray(base), q, cand))
    neg, order = jax.lax.top_k(-pd, K)
    return (np.asarray(-neg),
            np.asarray(jnp.take_along_axis(cand, order, axis=1)))


@pytest.mark.parametrize("kind", ["pq", "pq_nores"])
def test_query_pipeline_pq_builds_no_union(kind, data, indexes, monkeypatch):
    """query_pipeline(quant="pq") on the CPU builds no union (the host
    dedupe is gone from its preparation) and still returns what the JAX
    composition returns: distances rtol 1e-6, ids equal but for exact
    ties."""
    j, p = indexes[kind]
    base = data["base"].astype(np.float32)
    queries = data["query"].astype(np.float32)
    d_j, i_j = _jax_pq_pipeline(j, base, queries, tile=64)

    def no_union(*args, **kwargs):
        raise AssertionError("the pq branch built a union")

    monkeypatch.setattr(tp, "union_probe_tiles", no_union)
    step, args, stats = tp.query_pipeline(
        p, base, queries, nprobe=NPROBE, coarse_probe=COARSE_PROBE, k=K,
        quant="pq", tile=64, device="cpu")
    assert stats["union"] is None and stats["pos"] is None
    calls = k3.pq_probed_distances_plain.calls
    d_t, i_t = (x.numpy() for x in step(*args))
    assert k3.pq_probed_distances_plain.calls == calls + 1
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)
    gap = np.diff(d_j, axis=1) == 0
    tied = np.zeros_like(d_j, bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    np.testing.assert_array_equal(i_t[~tied], i_j[~tied])
