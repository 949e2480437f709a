"""IVF(-PQ) index storage layout — the port of prefhetch_tpu/index/types.py.

Inverted lists live as dense, padded tensors, the same layout and the same
npz fields as the JAX package, so either package reads the other's index:

- ``list_ids   [nlist, lmax] int32``  — global vector ids, -1 padding
- ``list_sizes [nlist] int32``        — true (unpadded) list lengths
- one payload:
  - ``list_vectors [nlist, lmax, d] float32``   (IVF-Flat)
  - ``list_codes   [nlist, lmax, M] uint8`` + ``codebooks`` (IVF-PQ), with
    ``list_recon [nlist, lmax, d] bfloat16``, the dense reconstruction the
    scan reads

A plain dataclass of tensors replaces the flax pytree. PQ codes stay uint8
on the device (the JAX package widens them to int32 for the TPU's lanes).
``host_arrays`` keeps numpy copies of what the tiled re-pack reads
(index/tiling.py); a bf16 payload is kept there as its raw int16 bits,
since numpy has no bfloat16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from prefhetch_tpu_torch.utils.config import IndexParams

LANE = 128


def pad_to_lane(n: int) -> int:
    return max(LANE, -(-n // LANE) * LANE)


@dataclasses.dataclass
class IVFIndex:
    """Dense padded IVF(-PQ) index; every tensor on one device."""

    centroids: torch.Tensor                       # [nlist, d] f32
    list_ids: torch.Tensor                        # [nlist, lmax] i32, -1 pad
    list_sizes: torch.Tensor                      # [nlist] i32
    list_vectors: Optional[torch.Tensor] = None   # [nlist, lmax, d] f32
    list_codes: Optional[torch.Tensor] = None     # [nlist, lmax, M] u8
    codebooks: Optional[torch.Tensor] = None      # [M, ksub, dsub] f32
    list_recon: Optional[torch.Tensor] = None     # [nlist, lmax, d] bf16
    list_norms: Optional[torch.Tensor] = None     # [nlist, lmax] f32
    params: IndexParams = dataclasses.field(default_factory=IndexParams)
    ntotal_host: Optional[int] = None
    # numpy copies (keys: payload, norms, ids, sizes, codes) for the host
    # re-pack; a bf16 payload as its int16 bit pattern
    host_arrays: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict
    )

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def lmax(self) -> int:
        return self.list_ids.shape[1]

    @property
    def d(self) -> int:
        return self.centroids.shape[1]

    @property
    def uses_pq(self) -> bool:
        return self.list_codes is not None

    @property
    def ntotal(self) -> int:
        if self.ntotal_host is not None:
            return self.ntotal_host
        return int(self.list_sizes.sum())

    def reconstruct_centroids(self) -> np.ndarray:
        """Centroid export for the client (privacy step 1)."""
        return self.centroids.cpu().numpy()
