"""Exact re-rank and vector retrieval — the port of prefhetch_tpu/ops/rerank.py.

Server stage 6 (reference: src/server/server_lib.cpp:140-167): exact
squared-L2 between each query and its named candidates, a gather plus a
batched product in full f32. Server stage 8 (server_lib.cpp:169-196): raw
gather of the named vectors.

Candidate ids index the base matrix with plain torch indexing, so a -1 pad id
wraps to the last row exactly as the JAX package's gather does.
"""

from __future__ import annotations

import torch

from prefhetch_tpu_torch.ops.topk import topk_smallest


def exact_rerank(
    base: torch.Tensor,       # [nbase, d] f32
    queries: torch.Tensor,    # [nq, d]
    cand_ids: torch.Tensor,   # [nq, P] int — candidate ids
) -> torch.Tensor:
    """Exact squared-L2 distances [nq, P] of the named candidates."""
    queries = queries.to(torch.float32)
    vecs = base[cand_ids.long()]                              # [nq, P, d]
    qsq = torch.sum(queries * queries, dim=-1)                # [nq]
    vsq = torch.sum(vecs * vecs, dim=-1)                      # [nq, P]
    cross = torch.bmm(vecs, queries[:, :, None])[..., 0]      # [nq, P]
    return torch.clamp(qsq[:, None] + vsq - 2.0 * cross, min=0.0)


def fetch_vectors(base: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather raw vectors [nq, K, d] for the retrieval endpoint."""
    return base[ids.long()]


def final_topk(
    scores: torch.Tensor,     # [nq, P] f32 — exact re-rank distances
    cand_ids: torch.Tensor,   # [nq, P] — the candidates the scores belong to
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids [nq, k], dists [nq, k]) ascending — the fused /search route's
    final select."""
    vals, order = topk_smallest(scores, k)
    return torch.gather(cand_ids, 1, order), vals
