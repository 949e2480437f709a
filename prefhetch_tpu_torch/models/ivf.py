"""IVF index model families: IVF-Flat, IVF-PQ and IVF-SQ8 — the port of
prefhetch_tpu/models/ivf.py.

The faiss-fork-equivalent model layer (reference C7, SURVEY.md §2.1): each
model owns a trained IVFIndex and exposes both

- the *protocol-decomposed* service used by the server engine
  (``search_encrypted``-style coarse scan over client-chosen lists), and
- a convenience local ``search`` (assign + scan + select in-process) for
  testing and non-private deployments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.index.build import (
    build_ivf_index, load_index, save_index,
)
from prefhetch_tpu_torch.index.types import IVFIndex
from prefhetch_tpu_torch.ops.distances import rank_centroids
from prefhetch_tpu_torch.ops.rerank import exact_rerank
from prefhetch_tpu_torch.ops.scan import (
    ScanResult, coarse_scan_flat, coarse_scan_pq, coarse_scan_sq8,
)
from prefhetch_tpu_torch.ops.topk import topk_select_segmented
from prefhetch_tpu_torch.utils.config import IndexParams


class _IVFBase:
    """Shared IVF behavior over the dense padded index layout."""

    def __init__(self, params: IndexParams,
                 device: "str | torch.device" = "cuda"):
        self.params = params
        self.device = resolve_device(device)
        self.index: Optional[IVFIndex] = None
        self.nprobe: int = 1  # mirrors faiss Index::nprobe mutable knob

    # -- lifecycle -----------------------------------------------------
    def train_add(self, train: np.ndarray, base: np.ndarray) -> None:
        """train + add in one pass (reference: server_lib.cpp:71,80)."""
        self.index = build_ivf_index(train, base, self.params, self.device)

    def save(self, directory: str) -> str:
        if self.index is None:
            raise RuntimeError("index not trained")
        return save_index(self.index, directory)

    @classmethod
    def load(cls, path: str,
             device: "str | torch.device" = "cuda") -> "_IVFBase":
        idx = load_index(path, device)
        model = cls(idx.params, device=device)
        model.index = idx
        return model

    @property
    def is_trained(self) -> bool:
        return self.index is not None

    @property
    def ntotal(self) -> int:
        return 0 if self.index is None else self.index.ntotal

    def reconstruct_centroids(self) -> np.ndarray:
        """quantizer->reconstruct loop equivalent (server_lib.cpp:101-109)."""
        return self.index.reconstruct_centroids()

    def _q(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32,
                               device=self.device)

    def _p(self, probe_ids) -> torch.Tensor:
        return torch.as_tensor(probe_ids, device=self.device).long()

    # -- protocol services ----------------------------------------------
    def coarse_scan(self, queries, probe_ids) -> ScanResult:
        """All-candidate scan of client-chosen lists (SURVEY.md §2.3)."""
        raise NotImplementedError

    # -- local convenience search ----------------------------------------
    def search(
        self, queries: np.ndarray, k: int, coarse_probe: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """In-process pipeline: rank centroids → coarse scan → segmented
        top-coarse_probe, cut to k. Scores are the scan's coarse distances
        (ADC or SQ8 for the compressed models)."""
        idx = self.index
        if idx.params.metric == "cosine":
            from prefhetch_tpu_torch.data.synthetic import normalize_rows

            queries = normalize_rows(np.asarray(queries))
        q = self._q(np.asarray(queries, np.float32))
        _, probe = rank_centroids(q, idx.centroids, self.nprobe)
        res = self.coarse_scan(q, probe)
        kk = k if coarse_probe is None else coarse_probe
        d, pos = topk_select_segmented(res.distances, kk, self.nprobe)
        ids = torch.gather(res.ids, 1, pos)
        return d[:, :k].cpu().numpy(), ids[:, :k].cpu().numpy()


class IVFFlat(_IVFBase):
    """IVF with uncompressed vectors in the inverted lists."""

    def __init__(self, params: Optional[IndexParams] = None,
                 device: "str | torch.device" = "cuda", **kw):
        params = params or IndexParams(pq_m=0, **kw)
        if params.uses_pq:
            params = dataclasses.replace(params, pq_m=0)
        super().__init__(params, device)

    def coarse_scan(self, queries, probe_ids) -> ScanResult:
        idx = self.index
        return coarse_scan_flat(
            idx.list_vectors, idx.list_ids, idx.list_sizes,
            self._q(queries), self._p(probe_ids), idx.list_norms,
        )


class IVFPQ(_IVFBase):
    """IVF-PQ: 8-bit PQ codes in the lists, ADC candidate scoring.

    Reference constructor parity: IndexIVFPQ(quantizer, d, nlist, M, nbits)
    (src/server/server_lib.cpp:34-36).
    """

    def __init__(self, params: Optional[IndexParams] = None,
                 device: "str | torch.device" = "cuda", **kw):
        super().__init__(params or IndexParams(**kw), device)
        if not self.params.uses_pq:
            raise ValueError("IVFPQ requires pq_m > 0")

    def coarse_scan(self, queries, probe_ids) -> ScanResult:
        idx = self.index
        if idx.list_recon is not None:
            # ADC distance computed as ‖q − z‖² over the precomputed
            # reconstructions (equal values up to bf16 rounding; a dense
            # product instead of per-code LUT gathers)
            return coarse_scan_flat(
                idx.list_recon, idx.list_ids, idx.list_sizes,
                self._q(queries), self._p(probe_ids), idx.list_norms,
            )
        return coarse_scan_pq(
            idx.centroids, idx.list_codes, idx.list_ids, idx.list_sizes,
            idx.codebooks, self._q(queries), self._p(probe_ids),
            by_residual=idx.params.by_residual,
        )


class IVFSQ8(_IVFBase):
    """IVF with per-dimension 8-bit scalar quantization
    (faiss IndexIVFScalarQuantizer QT_8bit analog): d bytes/vector, decoded
    on the fly inside the scan."""

    def __init__(self, params: Optional[IndexParams] = None,
                 device: "str | torch.device" = "cuda", **kw):
        params = params or IndexParams(pq_m=0, quantizer="sq8", **kw)
        if params.quantizer != "sq8":
            params = dataclasses.replace(params, quantizer="sq8")
        super().__init__(params, device)

    def coarse_scan(self, queries, probe_ids) -> ScanResult:
        idx = self.index
        return coarse_scan_sq8(
            idx.list_sq, idx.sq_vmin, idx.sq_scale,
            idx.list_ids, idx.list_sizes,
            self._q(queries), self._p(probe_ids),
        )


def rerank_exact(
    base: np.ndarray, queries: np.ndarray, cand_ids: np.ndarray,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Module-level exact rerank over raw base vectors (server stage 6)."""
    dev = resolve_device(device)
    return exact_rerank(
        torch.as_tensor(np.asarray(base, np.float32), device=dev),
        torch.as_tensor(np.asarray(queries, np.float32), device=dev),
        torch.as_tensor(np.asarray(cand_ids), device=dev),
    ).cpu().numpy()
