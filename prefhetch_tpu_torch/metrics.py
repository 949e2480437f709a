"""Recall/MRR benchmark scoring — exact parity with the reference oracle.

Reimplements ``benchmark_results`` (reference: src/client/client_lib.cpp:243-337)
bit-for-bit, including its idiosyncrasies (SURVEY.md §3.5):

- recall@n counts ground-truth ids from the **top-K GT prefix** (all K=100 of
  them) found within the top-n *observed* prefix, divided by n·nquery — so
  recall@1 can credit ANY of the 100 GT ids appearing at observed rank 0,
  not just GT[0].
- MRR@n credits only the FIRST ground-truth id (j == 0), adding 1/(k+1) when
  it is found at observed rank k < n.
- The inner scan breaks on the first match per GT id.

Copy of prefhetch_tpu/metrics.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class BenchmarkReport:
    recall_1: float
    recall_10: float
    recall_100: float
    mrr_1: float
    mrr_10: float
    mrr_100: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def benchmark_results(
    observed_idx: np.ndarray,   # (nquery, K) int — client's final top-K ids
    ground_truth: np.ndarray,   # (gt_nq, gt_nn) int — ivecs ground truth
    k: int = 100,
) -> BenchmarkReport:
    """Score observed results against ground truth, reference semantics.

    Mirrors the nested O(K²) scan of src/client/client_lib.cpp:267-316 but
    vectorized: for each query, find the observed rank of each of the first
    K ground-truth ids (first occurrence), then bucket.
    """
    observed_idx = np.asarray(observed_idx)
    ground_truth = np.asarray(ground_truth)
    nquery = observed_idx.shape[0]
    gt_nn = ground_truth.shape[1]
    if k > gt_nn:
        # reference guard: client_lib.cpp:260-266
        raise ValueError(
            "K greater than nearest neigbours per query in ground truth dataset"
        )
    if observed_idx.shape[1] < k:
        raise ValueError(f"observed results must have >= K={k} columns")

    gt = ground_truth[:nquery, :k]            # (nq, K) — top-K GT prefix
    obs = observed_idx[:, :k]                 # (nq, K)

    # rank[i, j] = first observed rank of gt[i, j], or K if absent.
    # (The reference breaks on first match — np.argmax on a boolean match
    # matrix returns the first True, identical semantics.)
    match = gt[:, :, None] == obs[:, None, :]          # (nq, K, K)
    found = match.any(axis=2)                          # (nq, K)
    first_rank = np.where(found, match.argmax(axis=2), k)

    recall_1 = int((first_rank < 1).sum())
    recall_10 = int((first_rank < 10).sum())
    recall_100 = int((first_rank < 100).sum())

    # MRR considers only GT id j == 0 (client_lib.cpp:283-291).
    r0 = first_rank[:, 0].astype(np.float64)
    rr = 1.0 / (r0 + 1.0)
    mrr_1 = float(np.where(r0 < 1, rr, 0.0).sum())
    mrr_10 = float(np.where(r0 < 10, rr, 0.0).sum())
    mrr_100 = float(np.where(r0 < 100, rr, 0.0).sum())

    # Totals exactly as printed by the reference (client_lib.cpp:318-330).
    return BenchmarkReport(
        recall_1=recall_1 / (1 * nquery),
        recall_10=recall_10 / (10 * nquery),
        recall_100=recall_100 / (100 * nquery),
        mrr_1=mrr_1 / nquery,
        mrr_10=mrr_10 / nquery,
        mrr_100=mrr_100 / nquery,
    )


def benchmark_results_scalar(
    observed_idx: np.ndarray, ground_truth: np.ndarray, k: int = 100
) -> BenchmarkReport:
    """Direct, loop-for-loop transcription of the reference scoring loop.

    Used as a test oracle for the vectorized version above
    (reference: src/client/client_lib.cpp:267-316).
    """
    nquery = observed_idx.shape[0]
    gt_nn = ground_truth.shape[1]
    if k > gt_nn:
        raise ValueError(
            "K greater than nearest neigbours per query in ground truth dataset"
        )
    mrr_1 = mrr_10 = mrr_100 = 0.0
    nq_r1 = nq_r10 = nq_r100 = 0
    for i in range(nquery):
        for j in range(k):
            for kk in range(k):
                if ground_truth[i, j] == observed_idx[i, kk]:
                    if kk < 1:
                        nq_r1 += 1
                    if kk < 10:
                        nq_r10 += 1
                    if kk < 100:
                        nq_r100 += 1
                    if j == 0:
                        if kk < 1:
                            mrr_1 += 1.0 / (kk + 1)
                        if kk < 10:
                            mrr_10 += 1.0 / (kk + 1)
                        if kk < 100:
                            mrr_100 += 1.0 / (kk + 1)
                    break
    return BenchmarkReport(
        recall_1=nq_r1 / (1 * nquery),
        recall_10=nq_r10 / (10 * nquery),
        recall_100=nq_r100 / (100 * nquery),
        mrr_1=mrr_1 / nquery,
        mrr_10=mrr_10 / nquery,
        mrr_100=mrr_100 / nquery,
    )
