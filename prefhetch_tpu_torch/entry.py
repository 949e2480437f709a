"""Entry points — the port of __graft_entry__.py.

- ``entry(device)``    → (query_step, example_args) for the flagship
                         model: the dense IVF-PQ query step (centroid
                         ranking → coarse scan over the bf16 PQ
                         reconstructions → top-P select → exact re-rank →
                         top-K) on a tiny index built from a seed.
- ``dryrun_multichip`` → one sharded train + query step over a mesh of
                         shards (parallel/dryrun.py).

The JAX step is one jittable program; here ``query_step`` is a plain
function of tensors that runs eagerly on the tensors' device, so the same
function serves the tiny index and the SIFT1M one.

    python -c "from prefhetch_tpu_torch.entry import entry; \
fn, args = entry(device='cpu'); print(fn(*args)[0].shape)"
"""

from __future__ import annotations

import torch

from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.index.build import build_ivf_index
from prefhetch_tpu_torch.index.types import IVFIndex
from prefhetch_tpu_torch.ops.distances import rank_centroids
from prefhetch_tpu_torch.ops.rerank import exact_rerank
from prefhetch_tpu_torch.ops.scan import coarse_scan_flat
from prefhetch_tpu_torch.ops.topk import topk_select, topk_smallest
from prefhetch_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
from prefhetch_tpu_torch.utils.config import IndexParams

# the JAX entry's constants: probed lists, coarse candidates kept, results
NPROBE, COARSE_PROBE, K = 6, 64, 32


def _build_tiny(nbase=2048, ntrain=4096, d=128, nlist=16, pq_m=16, nq=8,
                seed=3, device: "str | torch.device" = "cuda"
                ) -> tuple[IVFIndex, torch.Tensor, torch.Tensor]:
    """(index, base [nbase, d] f32, queries [nq, d] f32) on ``device``: the
    JAX ``_build_tiny``'s dataset (bit-equal for the same seed) and index
    parameters, the index trained by the port."""
    dev = resolve_device(device)
    data = make_clustered_dataset(
        nbase=nbase, ntrain=ntrain, nquery=nq, d=d,
        n_clusters=max(8, nlist), gt_k=10, seed=seed,
    )
    params = IndexParams(
        d=d, nlist=nlist, pq_m=pq_m, pq_nbits=8,
        kmeans_iters=5, pq_kmeans_iters=5,
    )
    index = build_ivf_index(data["train"], data["base"], params, dev)
    return (index, torch.as_tensor(data["base"], device=dev),
            torch.as_tensor(data["query"], device=dev))


def query_step(centroids, list_recon, list_ids, list_sizes, base, queries,
               *, nprobe: int = NPROBE, coarse_probe: int = COARSE_PROBE,
               k: int = K) -> tuple[torch.Tensor, torch.Tensor]:
    """The flagship dense step → (distances [nq, k] f32 ascending, ids
    [nq, k]). No ``list_norms`` is passed to the scan, as in the JAX step:
    the norms come from the bf16 payload. Every selection is the port's
    stable one, so ties go to the lower index as under ``lax.top_k``."""
    _, probe = rank_centroids(queries, centroids, nprobe)
    res = coarse_scan_flat(list_recon, list_ids, list_sizes, queries, probe)
    _, pos = topk_select(res.distances, coarse_probe)
    cand = torch.gather(res.ids, 1, pos)
    dists, order = topk_smallest(exact_rerank(base, queries, cand), k)
    return dists, torch.gather(cand, 1, order)


def entry(device: "str | torch.device" = "cuda"):
    """(query_step, example_args) with ``example_args = (centroids,
    list_recon, list_ids, list_sizes, base, queries)`` on ``device`` (the
    card unless the caller asks for ``"cpu"``; raises without CUDA)."""
    index, base, queries = _build_tiny(device=device)
    example_args = (
        index.centroids, index.list_recon, index.list_ids, index.list_sizes,
        base, queries,
    )
    return query_step, example_args
