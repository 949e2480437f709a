"""Tests that need the card: kernel K1 against its plain version, and the
engine on CUDA against the engine on the CPU. Without CUDA they skip. On a
machine with an H100 and nvcc (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports only torch and the port, so it runs where JAX is absent."""

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
from prefhetch_tpu_torch.engine.server import QueryEngine
from prefhetch_tpu_torch.index.build import build_ivf_index, index_from_numpy
from prefhetch_tpu_torch.ops import union_scan_min as usm
from prefhetch_tpu_torch.utils.config import (
    IndexParams, PipelineConfig, ProtocolParams,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the H100)")
    return torch.device("cuda", torch.cuda.current_device())


def _tiles(dev, ntiles, T, d, sizes, dtype, seed):
    """Integer-valued SIFT-like tiles: every f32 product and sum is exact,
    so kernel and plain version agree exactly before the bf16 store."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (ntiles + 1, T, d)).astype(np.float32)
    payload[-1] = 0
    for t, s in enumerate(sizes):
        payload[t, s:] = 0
    p = torch.from_numpy(payload).to(dev, dtype)
    return p, (p.float() ** 2).sum(-1), torch.tensor(sizes, dtype=torch.int32,
                                                     device=dev)


@pytest.mark.parametrize("T,d,nq,dtype", [
    (512, 128, 64, torch.bfloat16),
    (64, 32, 70, torch.bfloat16),
    (100, 200, 5, torch.float32),
])
def test_union_scan_min_kernel_matches_plain(cuda, T, d, nq, dtype):
    sizes = [T, 1, 0, T // 2, 0]
    payload, norms, sizes_t = _tiles(cuda, 4, T, d, sizes, dtype, seed=T + d)
    q = torch.from_numpy(np.random.default_rng(nq).integers(
        0, 256, (nq, d)).astype(np.float32)).to(cuda)
    union = torch.tensor([3, 0, 1, 2, 4, 4], dtype=torch.int32, device=cuda)
    before = usm.union_scan_min.launches
    d2k, mink = usm.union_scan_min(payload, norms, sizes_t, q, union)
    torch.cuda.synchronize()
    assert usm.union_scan_min.launches == before + 1
    d2r, minr = usm.union_scan_min_reference(payload, norms, sizes_t, q,
                                             union)
    assert torch.equal(torch.isinf(d2k), torch.isinf(d2r))
    assert torch.equal(d2k, d2r)          # exact sums, same RN rounding
    assert torch.equal(mink, minr)


def test_union_scan_min_kernel_rejects_what_it_cannot_take(cuda):
    payload, norms, sizes = _tiles(cuda, 2, 64, 12, [64, 3, 0],
                                   torch.bfloat16, seed=1)
    q = torch.zeros((4, 12), device=cuda)
    union = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="divisible by 8"):
        usm.union_scan_min(payload, norms, sizes, q, union)
    payload, norms, sizes = _tiles(cuda, 2, 64, 16, [64, 3, 0],
                                   torch.bfloat16, seed=1)
    q = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        usm.union_scan_min(payload, norms, sizes, q, union.long())
    with pytest.raises(ValueError, match="bf16 or f32"):
        usm.union_scan_min(payload.half(), norms, sizes, q, union)


def test_engine_on_cuda_matches_cpu(cuda, monkeypatch):
    """The whole fused route on the card (through K1) against the same
    route on the CPU (through K1's plain version), same index."""
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    data = make_clustered_dataset(nbase=2048, ntrain=4000, nquery=8, d=32,
                                  n_clusters=40, gt_k=50, seed=9)
    cfg = PipelineConfig(
        index=IndexParams(d=32, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=6, coarse_probe=40, k=10, nquery=4),
        nbase=2048,
    )
    cpu_idx = build_ivf_index(data["train"], data["base"], cfg.index,
                              device="cpu")
    arrays = {
        "centroids": cpu_idx.centroids.numpy(),
        "list_ids": cpu_idx.list_ids.numpy(),
        "list_sizes": cpu_idx.list_sizes.numpy(),
        "list_norms": cpu_idx.list_norms.numpy(),
        "list_codes": cpu_idx.list_codes.numpy(),
        "codebooks": cpu_idx.codebooks.numpy(),
        "list_recon_bf16": cpu_idx.host_arrays["payload"],
    }
    engines = []
    for dev, idx in (("cpu", cpu_idx),
                     (cuda, index_from_numpy(arrays, cfg.index, cuda))):
        e = QueryEngine(cfg, device=dev)
        e.serve_tile = 64
        e.set_index(idx, data["base"])
        engines.append(e)
    q = data["query"]
    cents = engines[0].retrieve_centroids()
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6]
    before = usm.union_scan_min.launches
    ids_c, d_c = engines[0].search_fused(q, probes, 10)
    ids_g, d_g = engines[1].search_fused(q, probes, 10)
    assert usm.union_scan_min.launches == before + 1
    np.testing.assert_array_equal(d_g, d_c)   # exact re-rank, integer data
    for r in range(q.shape[0]):
        assert set(ids_g[r]) == set(ids_c[r])
