"""Smallest-k selection — the port of prefhetch_tpu/ops/topk.py.

Invalid (padding) lanes hold PAD_DISTANCE so they never enter a result.
Every selection here is a stable ascending sort cut to k: ``lax.top_k``
breaks ties toward the lower index and ``torch.topk`` promises no order
among ties, so sorting stably keeps the JAX package's tie order (padded
tile slots all share one value, and the kept set must not depend on the
device's sort).
"""

from __future__ import annotations

import torch

# Large finite sentinel: finite in f32, +inf once rounded to bf16.
PAD_DISTANCE = 3.4e38


def topk_smallest(
    x: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(k smallest values of the last axis ascending, their positions), ties
    toward the lower index — ``lax.top_k(-x, k)`` negated back."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_select(
    distances: torch.Tensor,   # [..., n] — invalid lanes hold PAD_DISTANCE
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(k smallest distances ascending, their positions)."""
    return topk_smallest(distances, k)


def topk_select_segmented(
    distances: torch.Tensor,   # [nq, n_segments·seg] — PAD at invalid lanes
    k: int,
    n_segments: int,
    level1_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level exact top-k: per-segment top-k, then top-k of survivors.

    Exact for any segmentation (the global k smallest hold at most k members
    per segment). Returns positions in the ORIGINAL flat layout. level1_bf16
    runs the first level on bfloat16 values (selection near the k-th
    boundary may then differ within bf16 rounding; the triage pipeline's
    exact re-rank absorbs that). When k ≥ seg the first level would keep
    every lane, so the call collapses to one flat top-k (a bf16 input is
    selected in f32 and returned as bf16, as the JAX package does)."""
    nq, width = distances.shape
    seg = width // n_segments
    kk = min(k, seg)
    if kk >= seg:
        if distances.dtype == torch.bfloat16:
            vals, idx = topk_smallest(distances.to(torch.float32), k)
            return vals.to(torch.bfloat16), idx
        return topk_select(distances, k)
    d3 = distances.reshape(nq * n_segments, seg)
    if level1_bf16:
        d3 = d3.to(torch.bfloat16)
    v1, i1 = topk_smallest(d3, kk)
    v1 = v1.reshape(nq, n_segments * kk)
    i1 = i1.reshape(nq, n_segments * kk)
    v2, i2 = topk_smallest(v1, k)
    seg_slot = i2 // kk
    lane = torch.gather(i1, 1, i2)
    return v2.to(distances.dtype), seg_slot * seg + lane
