"""Lloyd's k-means in PyTorch — the port of prefhetch_tpu/ops/kmeans.py.

Same training recipe as the JAX package, so both train the same quantizer
from the same data up to float summation order:

- FAISS Clustering defaults: subsample to 256 points per centroid, init from
  a random subset, both drawn from numpy ``default_rng(seed)`` on the host —
  the draws are identical to the JAX package's;
- assignment = argmin of ``‖c‖² − 2·x·cᵀ`` (``‖x‖²`` omitted: argmin-
  invariant), chunked over the training set;
- update = per-centroid sums / counts (``index_add_``; the JAX package uses a
  one-hot matmul for the MXU);
- empty clusters become perturbed copies of the largest cluster's centroid;
- the spherical option re-projects centroids to the unit sphere.

Runs in full f32 on the card (``device.resolve_device`` turns TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from prefhetch_tpu_torch.device import resolve_device

# FAISS Clustering default: at most this many training points per centroid.
MAX_POINTS_PER_CENTROID = 256


def _repair_and_project(
    sums: torch.Tensor,      # [..., k, d]
    counts: torch.Tensor,    # [..., k]
    spherical: bool,
) -> torch.Tensor:
    """New centroids from the sums, with the JAX package's empty-cluster
    repair (kmeans.py:87-97): every empty centroid becomes a slightly
    perturbed copy of the largest cluster's centroid."""
    new_c = sums / torch.clamp(counts, min=1.0)[..., None]
    empty = counts == 0
    donor = torch.argmax(counts, dim=-1, keepdim=True)            # [..., 1]
    donor_c = torch.take_along_dim(new_c, donor[..., None], dim=-2)
    rank = torch.cumsum(empty.to(torch.float32), dim=-1) * empty  # 1,2,..
    eps = 1e-4 * rank[..., None]
    repaired = donor_c * (1.0 + eps) + eps
    new_c = torch.where(empty[..., None], repaired, new_c)
    if spherical:
        norm = torch.linalg.vector_norm(new_c, dim=-1, keepdim=True)
        new_c = new_c / torch.clamp(norm, min=1e-12)
    return new_c


def lloyd_iterations(
    x: torch.Tensor,            # [n, d] f32
    centroids: torch.Tensor,    # [k, d] f32 — the init
    iters: int,
    chunk: int = 4096,
    spherical: bool = False,
) -> torch.Tensor:
    """Run ``iters`` Lloyd iterations from ``centroids``; returns [k, d]."""
    k, d = centroids.shape
    c = centroids
    for _ in range(iters):
        csq = torch.sum(c * c, dim=-1)
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device)
        for s in range(0, x.shape[0], chunk):
            xc = x[s : s + chunk]
            a = torch.argmin(csq[None, :] - 2.0 * (xc @ c.T), dim=-1)
            sums.index_add_(0, a, xc)
            counts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
        c = _repair_and_project(sums, counts, spherical)
    return c


def lloyd_iterations_batched(
    xs: torch.Tensor,           # [B, n, d] f32
    centroids: torch.Tensor,    # [B, k, d] f32 — the inits
    iters: int,
    chunk: int = 4096,
) -> torch.Tensor:
    """``lloyd_iterations`` over B independent problems at once (the JAX
    package vmaps the loop); returns [B, k, d]."""
    B, k, d = centroids.shape
    c = centroids
    for _ in range(iters):
        csq = torch.sum(c * c, dim=-1)                           # [B, k]
        sums = torch.zeros((B, k, d), dtype=torch.float32, device=xs.device)
        counts = torch.zeros((B, k), dtype=torch.float32, device=xs.device)
        for s in range(0, xs.shape[1], chunk):
            xc = xs[:, s : s + chunk]                            # [B, c, d]
            d2 = csq[:, None, :] - 2.0 * torch.bmm(xc, c.transpose(1, 2))
            a = torch.argmin(d2, dim=-1)                         # [B, c]
            sums.scatter_add_(1, a[..., None].expand(-1, -1, d), xc)
            counts.scatter_add_(1, a, torch.ones_like(a, dtype=torch.float32))
        c = _repair_and_project(sums, counts, spherical=False)
    return c


def train_kmeans(
    x: np.ndarray,
    k: int,
    iters: int = 25,
    seed: int = 1234,
    chunk: int = 4096,
    subsample: bool = True,
    spherical: bool = False,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Train k centroids on x [n, d]; returns centroids [k, d] float32.

    Host part identical to the JAX package (subsample + random-subset init
    from ``default_rng(seed)``), Lloyd loop on ``device``."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n < k:
        raise ValueError(f"need at least k={k} training points, got {n}")
    rng = np.random.default_rng(seed)
    if subsample and n > k * MAX_POINTS_PER_CENTROID:
        sel = rng.permutation(n)[: k * MAX_POINTS_PER_CENTROID]
        x = x[sel]
        n = x.shape[0]
    init = x[rng.permutation(n)[:k]].copy()
    c = lloyd_iterations(
        torch.tensor(x, device=dev), torch.tensor(init, device=dev),
        iters, chunk=min(chunk, n), spherical=spherical,
    )
    return c.cpu().numpy()


def train_kmeans_batched(
    xs: np.ndarray,   # [B, n, d] — B independent k-means problems
    k: int,
    iters: int = 25,
    seed: int = 1234,
    chunk: int = 4096,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """k-means over B subproblems (PQ codebook training, one problem per
    sub-quantizer). Returns [B, k, d]."""
    dev = resolve_device(device)
    xs = np.asarray(xs, np.float32)
    B, n, d = xs.shape
    rng = np.random.default_rng(seed)
    if n > k * MAX_POINTS_PER_CENTROID:
        sel = rng.permutation(n)[: k * MAX_POINTS_PER_CENTROID]
        xs = xs[:, sel]
        n = xs.shape[1]
    inits = np.stack([xs[b, rng.permutation(n)[:k]] for b in range(B)])
    c = lloyd_iterations_batched(
        torch.tensor(xs, device=dev), torch.tensor(inits, device=dev),
        iters, chunk=min(chunk, n),
    )
    return c.cpu().numpy()
