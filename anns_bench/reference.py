"""The plain reference: exact squared-L2 search over the run's corpus.

Plain PyTorch on the run's device, float32 products of integer-valued
vectors (exact: every product and partial sum stays below 2^24) and float64
where values are compared. It imports nothing of the program and takes
nothing the program made: it works from the corpus and queries the harness
generated, and reads the program's answers only to judge them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

ID_BITS = 21            # ids below 2^21 ride in the low bits of a sort key


class Reference:
    def __init__(self, base: np.ndarray, device: torch.device):
        if len(base) >= 1 << ID_BITS:
            raise ValueError("the reference's sort keys hold ids < 2^21")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = device
        self.base = torch.as_tensor(base, dtype=torch.float32, device=device)
        self.base_sq = (self.base * self.base).sum(1)

    def exact_topk(self, queries: np.ndarray, k: int,
                   block: int = 128) -> np.ndarray:
        """Exact top-k ids [nq, k] by squared L2, ties toward the lower id.

        Distances of integer vectors are exact integers in float32, so
        (distance, id) packs into one int64 key and one top-k orders by
        both."""
        q_all = torch.as_tensor(queries, dtype=torch.float32,
                                device=self.device)
        out = np.empty((len(queries), k), np.int64)
        ids = torch.arange(self.base.shape[0], device=self.device)
        for s in range(0, len(queries), block):
            q = q_all[s: s + block]
            d2 = (q * q).sum(1)[:, None] + self.base_sq[None] - 2.0 * (q @ self.base.T)
            key = (d2.round().to(torch.int64) << ID_BITS) | ids[None]
            top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
            out[s: s + block] = (top & ((1 << ID_BITS) - 1)).cpu().numpy()
        return out

    def distances(self, queries: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """float64 squared L2 [n, m] of each query to its named rows (ids
        outside the corpus read NaN)."""
        q = torch.as_tensor(queries, dtype=torch.float64, device=self.device)
        i = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        ok = (i >= 0) & (i < self.base.shape[0])
        rows = self.base[i.clamp(0, self.base.shape[0] - 1)].to(torch.float64)
        d = ((rows - q[:, None, :]) ** 2).sum(-1)
        return torch.where(ok, d, torch.nan).cpu().numpy()


def bf16_topk(ref: Reference, queries: np.ndarray, k: int,
              block: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """The control: the same search computed in bfloat16, the precision
    below the float32 the configuration states → (ids [nq, k], distances
    [nq, k] as bfloat16 gives them)."""
    base = ref.base.to(torch.bfloat16)
    bsq = (base * base).sum(1)
    ids_out = np.empty((len(queries), k), np.int64)
    d_out = np.empty((len(queries), k), np.float64)
    q_all = torch.as_tensor(queries, dtype=torch.bfloat16, device=ref.device)
    for s in range(0, len(queries), block):
        q = q_all[s: s + block]
        d2 = (q * q).sum(1)[:, None] + bsq[None] - 2.0 * (q @ base.T)
        vals, idx = torch.topk(d2.float(), k, dim=1, largest=False, sorted=True)
        ids_out[s: s + block] = idx.cpu().numpy()
        d_out[s: s + block] = vals.cpu().numpy()
    return ids_out, d_out


def bf16_distances(ref: Reference, queries: np.ndarray,
                   ids: np.ndarray) -> np.ndarray:
    """The control's distances of named rows, computed in bfloat16."""
    q = torch.as_tensor(queries, dtype=torch.bfloat16, device=ref.device)
    i = torch.as_tensor(ids, dtype=torch.int64, device=ref.device)
    rows = ref.base[i].to(torch.bfloat16)
    diff = rows - q[:, None, :]
    return (diff * diff).sum(-1).to(torch.float64).cpu().numpy()
