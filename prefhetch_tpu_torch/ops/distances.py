"""Squared-L2 distances as matmuls — the port of prefhetch_tpu/ops/distances.py.

The classic expansion ``‖x‖² − 2·q·xᵀ + ‖q‖²`` in full f32 (the port turns
TF32 off, device.resolve_device), clamped at 0.
"""

from __future__ import annotations

import torch

from prefhetch_tpu_torch.ops.topk import topk_smallest


def pairwise_sq_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 between rows of q [nq, d] and x [n, d] → [nq, n]."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    qsq = torch.sum(q * q, dim=-1, keepdim=True)            # [nq, 1]
    xsq = torch.sum(x * x, dim=-1)                          # [n]
    d2 = qsq + xsq[None, :] - 2.0 * (q @ x.T)
    return torch.clamp(d2, min=0.0)


def rank_centroids(
    queries: torch.Tensor,       # [nq, d]
    centroids: torch.Tensor,     # [nlist, d]
    nprobe: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Client-side stage 3: the nprobe nearest centroids per query.
    Returns (distances [nq, nprobe] ascending, centroid ids [nq, nprobe])."""
    return topk_smallest(pairwise_sq_l2(queries, centroids), nprobe)
