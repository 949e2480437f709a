"""Brute-force exact L2 index — the port of prefhetch_tpu/models/flat.py.

Equivalent of faiss::IndexFlatL2, which the reference uses as the coarse
quantizer (reference: src/server/server_lib.cpp:33). Also serves as the
recall oracle for integration tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.ops.distances import pairwise_sq_l2
from prefhetch_tpu_torch.ops.topk import topk_smallest


class FlatL2:
    """Exact squared-L2 search over a dense base matrix (matmul + top-k)."""

    def __init__(self, d: int, device: "str | torch.device" = "cuda"):
        self.d = d
        self.device = resolve_device(device)
        self._base: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        return 0 if self._base is None else self._base.shape[0]

    def add(self, x: np.ndarray) -> None:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self._base = x if self._base is None else torch.cat([self._base, x])

    def reconstruct(self, i: int) -> np.ndarray:
        return self._base[i].cpu().numpy()

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances [nq, k] ascending, ids [nq, k])."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        d, i = topk_smallest(pairwise_sq_l2(q, self._base), k)
        return d.cpu().numpy(), i.cpu().numpy()
