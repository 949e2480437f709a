"""Port parity: prefhetch_tpu_torch/entry.py against __graft_entry__.py,
and the engine's dense coarse branch (indexes without a tiled view)
against the JAX engine.

The JAX ``entry()`` runs under ``jax.jit``; the port's ``query_step`` runs
on the CPU on the JAX-built tiny index, carried across with
``index_from_numpy``. Ids are equal wherever no two neighbouring distances
tie within 1e-5 relative; distances agree to rtol 1e-5 (the SIFT-style
data is integer-valued, so the exact re-rank is exact in f32 in both)."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.engine.server import QueryEngine as JEngine
from prefhetch_tpu.index.build import build_ivf_index
from prefhetch_tpu.ops.distances import rank_centroids as j_rank
from prefhetch_tpu.ops.rerank import exact_rerank as j_rerank
from prefhetch_tpu.ops.scan import coarse_scan_flat as j_scan
from prefhetch_tpu.ops.topk import topk_select as j_topk
from prefhetch_tpu.utils.config import (
    IndexParams, PipelineConfig, ProtocolParams,
)
from prefhetch_tpu_torch import entry as te
from prefhetch_tpu_torch.engine.server import QueryEngine as TEngine
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.ops.scan import coarse_scan_flat as t_scan
from prefhetch_tpu_torch.parallel import dryrun
from prefhetch_tpu_torch.serve.handlers import Dispatcher as TDispatcher
from prefhetch_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon")


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's step, its jitted output, and the port's tensors for
    its example args: the JAX ``_build_tiny`` index carried across with
    index_from_numpy (its bf16 ``list_recon`` as ml_dtypes bfloat16), base
    and queries from the JAX arrays."""
    fn, args = g.entry()
    out = tuple(np.asarray(o) for o in jax.jit(fn)(*args))
    idx, base, queries = g._build_tiny()
    arrays = {f: np.asarray(getattr(idx, f)) for f in FIELDS}
    # _build_tiny is deterministic: the entry's args are this index's
    np_args = [np.asarray(a) for a in args]
    for a, f in zip(np_args[:4], ("centroids", "list_recon", "list_ids",
                                  "list_sizes")):
        np.testing.assert_array_equal(a.view(np.uint8), arrays[f].view(
            np.uint8))
    params = tcfg.IndexParams(**vars(idx.params))
    t_idx = index_from_numpy(arrays, params, device="cpu")
    t_args = (t_idx.centroids, t_idx.list_recon, t_idx.list_ids,
              t_idx.list_sizes, torch.from_numpy(np.array(base)),
              torch.from_numpy(np.array(queries)))
    return np_args, t_args, out


def _assert_same_result(d_t, i_t, d_j, i_j):
    """Distances to rtol 1e-5; ids equal wherever a distance does not tie
    with a neighbour of its row within 1e-5 relative."""
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=0)
    near = np.abs(np.diff(d_j, axis=1)) <= RTOL * np.abs(d_j[:, 1:])
    tied = np.zeros_like(d_j, bool)
    tied[:, 1:] |= near
    tied[:, :-1] |= near
    np.testing.assert_array_equal(i_t[~tied], i_j[~tied])


def _scan_atol(q, x):
    """The coarse scans' tolerance, as for the slab scans (test_torch_serve):
    1e-5·(max‖q‖² + max‖x‖²). Their distances are ‖q‖² + ‖x‖² − 2⟨q, x⟩ in
    f32, summed in another order than XLA's, so the error scales with the
    norms, not with the (cancelled) distance."""
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    return 1e-5 * (float((q ** 2).sum(-1).max())
                   + float((x ** 2).sum(-1).max()))


def _assert_contract(d, ids):
    """tests/test_graft_entry.py's contract on the entry's output."""
    assert d.shape == ids.shape == (8, 32)
    assert np.isfinite(d).all()
    assert (np.diff(d, axis=1) >= -1e-3).all()
    assert ids.min() >= 0


def test_step_matches_jax_entry(jax_entry):
    """The port's query_step on the JAX-built tiny index equals the JAX
    entry() under jax.jit."""
    _, t_args, (d_j, i_j) = jax_entry
    d_t, i_t = te.query_step(*t_args)
    assert d_t.dtype == torch.float32
    _assert_contract(d_t.numpy(), i_t.numpy())
    _assert_same_result(d_t.numpy(), i_t.numpy(), d_j, i_j)


def test_port_entry_meets_the_contract():
    """entry(device="cpu") builds its own index and meets the JAX
    contract; its args sit on the CPU in the JAX layout."""
    fn, args = te.entry(device="cpu")
    assert fn is te.query_step
    assert all(a.device.type == "cpu" for a in args)
    cents, recon, ids, sizes, base, queries = args
    assert recon.dtype == torch.bfloat16 and recon.shape[:2] == ids.shape
    assert cents.shape == (16, 128) and sizes.shape == (16,)
    assert int(sizes.sum()) == base.shape[0] == 2048
    d, i = fn(*args)
    _assert_contract(d.numpy(), i.numpy())


def test_port_dataset_bit_equal_to_jax(jax_entry):
    """_build_tiny's base and queries are the JAX entry's, bit for bit."""
    np_args, _, _ = jax_entry
    _, base, queries = te._build_tiny(device="cpu")
    np.testing.assert_array_equal(base.numpy(), np_args[4])
    np.testing.assert_array_equal(queries.numpy(), np_args[5])
    assert base.dtype == queries.dtype == torch.float32


def _jax_step(args, nprobe, coarse_probe, k):
    """The JAX entry's step body at other constants."""
    cents, recon, ids, sizes, base, queries = args
    _, probe = j_rank(queries, cents, nprobe)
    res = j_scan(recon, ids, sizes, queries, probe)
    _, pos = j_topk(res.distances, coarse_probe)
    cand = jnp.take_along_axis(res.ids, pos, axis=1)
    pd = j_rerank(base, queries, cand)
    neg, order = jax.lax.top_k(-pd, k)
    return -neg, jnp.take_along_axis(cand, order, axis=1)


@pytest.mark.parametrize("nq,nprobe", [
    (8, 6),     # nq·nprobe ≥ nlist: JAX scores the whole index at once
    (2, 6),     # nq·nprobe < nlist: JAX gathers the probed slabs
    (8, 1),
], ids=["full-index", "slab-gather", "slab-gather-nprobe1"])
def test_step_at_both_scan_branches(jax_entry, nq, nprobe):
    """coarse_scan_flat on both of the JAX function's branches, then the
    whole step at those constants."""
    np_args, t_args, _ = jax_entry
    j_args = [jnp.asarray(a) for a in np_args[:5] + [np_args[5][:nq]]]
    t_args = t_args[:5] + (t_args[5][:nq],)
    _, probe = j_rank(j_args[5], j_args[0], nprobe)
    ref = j_scan(j_args[1], j_args[2], j_args[3], j_args[5], probe)
    got = t_scan(t_args[1], t_args[2], t_args[3], t_args[5],
                 torch.from_numpy(np.array(probe)))
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    recon = t_args[1].to(torch.float32).numpy()
    np.testing.assert_allclose(got.distances.numpy()[m],
                               np.asarray(ref.distances)[m], rtol=0,
                               atol=_scan_atol(np_args[5][:nq], recon))
    cp, k = 48 * nprobe, 16
    d_j, i_j = jax.jit(_jax_step, static_argnums=(1, 2, 3))(
        j_args, nprobe, cp, k)
    d_t, i_t = te.query_step(*t_args, nprobe=nprobe, coarse_probe=cp, k=k)
    assert d_t.shape == (nq, k)
    _assert_same_result(d_t.numpy(), i_t.numpy(), np.asarray(d_j),
                        np.asarray(i_j))


@pytest.fixture(scope="module")
def dense_setup():
    data = make_clustered_dataset(
        nbase=2048, ntrain=4000, nquery=8, d=32, n_clusters=40, gt_k=50,
        seed=9,
    )
    q = data["query"].astype(np.float32)
    return data, q


@pytest.mark.parametrize("kind", ["sq8", "pq-codes"])
def test_dense_coarsesearch_matches_jax(dense_setup, kind):
    """JSON /coarsesearch through the port's Dispatcher on an index with no
    tiled view (SQ8 codes; PQ codes without list_recon) takes the dense
    branch of QueryEngine.coarse_search, as the JAX engine does: ids and
    listSizesPerQuery equal, scores within the scans' tolerance."""
    data, q = dense_setup
    params = IndexParams(d=32, nlist=16, pq_m=0 if kind == "sq8" else 8,
                         quantizer="sq8" if kind == "sq8" else "auto",
                         kmeans_iters=8, pq_kmeans_iters=8)
    cfg = PipelineConfig(index=params,
                         protocol=ProtocolParams(nprobe=6, coarse_probe=40,
                                                 k=10, nquery=4),
                         nbase=2048)
    idx = build_ivf_index(data["train"], data["base"], params)
    if kind != "sq8":
        idx = idx.replace(list_recon=None)
    arrays = {f: np.asarray(getattr(idx, f)) for f in (
        "centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
        "codebooks", "list_sq", "sq_vmin", "sq_scale")
        if getattr(idx, f) is not None}
    assert ("list_sq" in arrays) == (kind == "sq8")
    tc = tcfg.PipelineConfig.from_json(cfg.to_json())
    engine = TEngine(tc, device="cpu")
    engine.set_index(index_from_numpy(arrays, tc.index, device="cpu"),
                     data["base"])
    assert engine._tiled_view is None
    je = JEngine(cfg)
    je.set_index(idx, data["base"])
    cents = np.asarray(idx.centroids)
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6].astype(np.int64)
    status, ctype, resp = TDispatcher(engine).handle(
        "POST", "/coarsesearch", {}, json.dumps({
            "preciseQuery": q.tolist(),
            "nearestCentroidIndexes": probes.tolist()}).encode())
    assert status == 200 and ctype == "application/json"
    out = json.loads(resp)
    s_j, i_j, z_j = je.coarse_search(q, probes)
    np.testing.assert_array_equal(out["listSizesPerQuery"], z_j)
    np.testing.assert_array_equal(out["coarseVectorIndexes"], i_j)
    assert len(out["coarseDistanceScores"]) == int(z_j.sum())
    np.testing.assert_allclose(out["coarseDistanceScores"], s_j, rtol=0,
                               atol=_scan_atol(q, data["base"]))


def test_entry_without_cuda_raises(monkeypatch):
    """entry() defaults to the card: without CUDA it raises and names
    device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te._build_tiny()


def test_entry_runs_without_jax():
    """prefhetch_tpu_torch.entry imports and runs on the CPU with jax,
    flax, ml_dtypes and the JAX package blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'prefhetch_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from prefhetch_tpu_torch.entry import entry\n"
        "fn, args = entry(device='cpu')\n"
        "d, ids = fn(*args)\n"
        "print(tuple(d.shape), int(ids.min()) >= 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(8, 32) True"


def test_dryrun_multichip_is_reexported():
    assert te.dryrun_multichip is dryrun.dryrun_multichip
