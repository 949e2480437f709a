"""Synthetic SIFT-style dataset generation.

The reference downloads SIFT-small from irisa.fr (reference: dataset.sh:4-10).
This environment has no network egress, so the framework ships a generator
that produces datasets with the same statistical shape as SIFT descriptors —
clustered, non-negative, integer-valued float32 vectors in [0, 255] — plus
exact brute-force ground truth in the same fvecs/ivecs layout, so every
downstream stage (including the recall/MRR oracle, §3.5 of SURVEY.md) is
exercised against real nearest-neighbor structure.

Copy of prefhetch_tpu/data/synthetic.py: the same seed gives the same arrays.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from prefhetch_tpu_torch.data.io import write_fvecs, write_ivecs


def make_clustered_dataset(
    nbase: int = 10_000,
    ntrain: int = 25_000,
    nquery: int = 100,
    d: int = 128,
    n_clusters: int = 200,
    gt_k: int = 100,
    seed: int = 42,
) -> Dict[str, np.ndarray]:
    """Generate {train, base, query, groundtruth} arrays.

    Mixture-of-Gaussians in [0, 255]^d, rounded to integers like SIFT
    descriptors. Queries are perturbed base-distribution samples so IVF
    probing has realistic cluster locality. Ground truth is exact squared-L2
    top-``gt_k`` over the base set (the metric used everywhere in the
    reference, e.g. src/server/server_lib.cpp:155-162).
    """
    rng = np.random.default_rng(seed)
    centers = rng.uniform(30.0, 225.0, size=(n_clusters, d))
    scales = rng.uniform(8.0, 30.0, size=(n_clusters, 1))

    def sample(n: int) -> np.ndarray:
        which = rng.integers(0, n_clusters, size=n)
        x = centers[which] + rng.normal(size=(n, d)) * scales[which]
        return np.clip(np.round(x), 0, 255).astype(np.float32)

    base = sample(nbase)
    train = sample(ntrain)
    query = sample(nquery)

    gt = brute_force_ground_truth(base, query, gt_k)
    return {"train": train, "base": base, "query": query, "groundtruth": gt}


def make_hard_dataset(
    nbase: int = 10_000,
    ntrain: int = 25_000,
    nquery: int = 100,
    d: int = 128,
    n_clusters: int = 200,
    gt_k: int = 100,
    seed: int = 42,
) -> Dict[str, np.ndarray]:
    """Generate a HARD {train, base, query, groundtruth} workload.

    The clustered generator produces well-separated clusters where IVF
    probing is nearly free (recall@10 = 1.0 at nprobe=16 — too easy to
    stress recall, see make_clustered_dataset). This variant makes the
    nearest-neighbor structure genuinely cross cluster boundaries:

    - heavy-tailed (Zipf) cluster weights — realistic list-size skew;
    - cluster scales comparable to inter-center distances, so Voronoi
      cells overlap and true neighbors spread over several lists;
    - 5% uniform background points with no cluster affinity;
    - queries perturbed off base points by ~one cluster radius, landing
      near cell boundaries.

    At the BASELINE SIFT1M operating point (nlist=1024, nprobe=16) the
    exact-IVF oracle's recall@10 is measurably below 1.0 on this set.
    """
    rng = np.random.default_rng(seed)
    centers = rng.uniform(30.0, 225.0, size=(n_clusters, d))
    scales = rng.uniform(35.0, 80.0, size=(n_clusters, 1))
    weights = 1.0 / np.arange(1, n_clusters + 1) ** 0.9
    weights /= weights.sum()

    def sample(n: int) -> np.ndarray:
        which = rng.choice(n_clusters, size=n, p=weights)
        x = centers[which] + rng.normal(size=(n, d)) * scales[which]
        n_bg = n // 20
        x[:n_bg] = rng.uniform(0.0, 255.0, size=(n_bg, d))
        perm = rng.permutation(n)
        return np.clip(np.round(x[perm]), 0, 255).astype(np.float32)

    base = sample(nbase)
    train = sample(ntrain)
    pick = rng.choice(nbase, size=nquery, replace=False)
    q = base[pick] + rng.normal(size=(nquery, d)) * 45.0
    query = np.clip(np.round(q), 0, 255).astype(np.float32)

    gt = brute_force_ground_truth(base, query, gt_k)
    return {"train": train, "base": base, "query": query, "groundtruth": gt}


def brute_force_ground_truth(
    base: np.ndarray, query: np.ndarray, k: int, block: int = 1024
) -> np.ndarray:
    """Exact top-k nearest neighbors (squared L2), ties broken by lower id.

    Blocked to bound memory at SIFT1M scale.
    """
    nq = query.shape[0]
    base_sq = (base.astype(np.float64) ** 2).sum(axis=1)
    out = np.empty((nq, k), dtype=np.int32)
    for s in range(0, nq, block):
        q = query[s : s + block].astype(np.float64)
        d2 = base_sq[None, :] - 2.0 * q @ base.T + (q**2).sum(axis=1, keepdims=True)
        # stable argsort => ties broken by lower index, matching a scan order
        idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
        out[s : s + block] = idx.astype(np.int32)
    return out


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """L2-normalize rows — the standard preparation for angular/cosine
    datasets (GloVe-style): on unit vectors, squared-L2 ordering equals
    cosine-similarity ordering (‖a−b‖² = 2 − 2·cosθ), so the entire L2
    pipeline serves angular search unchanged (BASELINE config 4)."""
    x = np.asarray(x, np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def make_angular_dataset(
    nbase: int = 10_000,
    ntrain: int = 20_000,
    nquery: int = 100,
    d: int = 100,
    n_clusters: int = 100,
    gt_k: int = 100,
    seed: int = 42,
) -> Dict[str, np.ndarray]:
    """GloVe-style angular dataset: dense real vectors, cosine ground truth.

    Vectors are returned unit-normalized; ground truth is exact top-k by
    cosine similarity (equivalently, by L2 on the normalized vectors)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)

    def sample(n):
        which = rng.integers(0, n_clusters, size=n)
        x = centers[which] + 0.4 * rng.normal(size=(n, d)).astype(np.float32)
        return normalize_rows(x)

    base = sample(nbase)
    train = sample(ntrain)
    query = sample(nquery)
    gt = brute_force_ground_truth(base, query, gt_k)
    return {"train": train, "base": base, "query": query, "groundtruth": gt}


def write_sift_style_dataset(
    out_dir: str, prefix: str = "synthetic", hard: bool = False, **kwargs
) -> Dict[str, str]:
    """Generate and persist a dataset in the reference's file layout.

    Produces ``{prefix}_learn.fvecs``, ``{prefix}_base.fvecs``,
    ``{prefix}_query.fvecs``, ``{prefix}_groundtruth.ivecs`` — the exact
    four files the reference consumes (src/server/server_lib.cpp:22-27,
    src/client/client_lib.cpp:12-14).
    """
    os.makedirs(out_dir, exist_ok=True)
    gen = make_hard_dataset if hard else make_clustered_dataset
    data = gen(**kwargs)
    paths = {
        "train": os.path.join(out_dir, f"{prefix}_learn.fvecs"),
        "base": os.path.join(out_dir, f"{prefix}_base.fvecs"),
        "query": os.path.join(out_dir, f"{prefix}_query.fvecs"),
        "groundtruth": os.path.join(out_dir, f"{prefix}_groundtruth.ivecs"),
    }
    write_fvecs(paths["train"], data["train"])
    write_fvecs(paths["base"], data["base"])
    write_fvecs(paths["query"], data["query"])
    write_ivecs(paths["groundtruth"], data["groundtruth"])
    return paths
