"""Measured leakage of the quantized coarse query (`coarseQueryCodes`) —
a copy of prefhetch_tpu/analysis/coarse_leakage.py (numpy only).

In encrypted-rerank mode the client never sends the full-precision query on
the coarse route: it sends PQ codes of (q − centroid[probe₀]) and the probe
list, and the server triages with the reconstruction q̂ (reference intent:
include/client/client_lib.h:28-36 — "Sending precise query temporarily").

This module QUANTIFIES what those codes reveal, against the honest-but-
curious server model. Two adversaries are measured:

- ``codes``  — the server as-is: it holds q̂ (codes + public codebooks +
  probed centroid). This is the protocol's actual disclosure.
- ``probes`` — a server that only saw the probe list (the minimum any IVF
  protocol reveals): its best point estimate of q is centroid[probe₀].

For each adversary guess g the report carries:

- ``snr_db``        — 10·log₁₀(E‖q‖² / E‖q−g‖²): reconstruction fidelity.
- ``top1_recovery`` — P[exact-NN(g) == exact-NN(q)] over the base set.
- ``topk_overlap``  — mean |NN_k(g) ∩ NN_k(q)|/k (k=10).

The *incremental* leakage of the codes is the codes-vs-probes delta: the
probe list already pins q to a Voronoi cell; the codes sharpen that to a PQ
cell (M·log₂(ksub) extra bits, e.g. 32 B at M=32/8-bit).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass
class AdversaryStats:
    snr_db: float
    top1_recovery: float
    topk_overlap: float
    k: int


@dataclass
class CoarseLeakageReport:
    adversaries: Dict[str, AdversaryStats] = field(default_factory=dict)
    code_bits: int = 0       # extra bits the codes disclose beyond probes
    nq: int = 0

    def summary(self) -> str:
        lines = [
            f"coarse-query leakage over {self.nq} queries "
            f"(codes add {self.code_bits} bits over the probe list):"
        ]
        for name, s in self.adversaries.items():
            lines.append(
                f"  {name:>6}: SNR {s.snr_db:6.2f} dB | "
                f"top-1 NN recovery {s.top1_recovery:5.3f} | "
                f"top-{s.k} overlap {s.topk_overlap:5.3f}"
            )
        return "\n".join(lines)


def _nn_topk(base: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Exact L2 top-k ids, blocked over queries (numpy, analysis-only)."""
    out = np.empty((len(queries), k), np.int64)
    bsq = (base.astype(np.float32) ** 2).sum(-1)
    for i in range(0, len(queries), 64):
        q = queries[i : i + 64].astype(np.float32)
        d2 = bsq[None, :] - 2.0 * (q @ base.T.astype(np.float32))
        out[i : i + 64] = np.argpartition(d2, k, axis=1)[:, :k]
        # order the k
        part = np.take_along_axis(d2, out[i : i + 64], axis=1)
        order = np.argsort(part, axis=1, kind="stable")
        out[i : i + 64] = np.take_along_axis(out[i : i + 64], order, axis=1)
    return out


def _stats(
    base: np.ndarray,
    queries: np.ndarray,
    guess: np.ndarray,
    true_topk: np.ndarray,
    k: int,
) -> AdversaryStats:
    err = queries.astype(np.float64) - guess.astype(np.float64)
    snr = (queries.astype(np.float64) ** 2).sum() / max(
        (err**2).sum(), 1e-30
    )
    guess_topk = _nn_topk(base, guess, k)
    top1 = float(np.mean(guess_topk[:, 0] == true_topk[:, 0]))
    ov = np.mean(
        [
            len(set(a.tolist()) & set(b.tolist())) / k
            for a, b in zip(guess_topk, true_topk)
        ]
    )
    return AdversaryStats(
        snr_db=float(10.0 * np.log10(snr)),
        top1_recovery=top1,
        topk_overlap=float(ov),
        k=k,
    )


def measure_coarse_leakage(
    index, base: np.ndarray, queries: np.ndarray, k: int = 10
) -> CoarseLeakageReport:
    """Measure what `coarseQueryCodes` + the probe list reveal about q.

    `index` is an IVFIndex with PQ codebooks (index/build.py), on any
    device. Reproduces the JAX package's client encode
    (client/pipeline.py:313-343) and server decode
    (serve/handlers.py:240-258).
    """
    cent = index.centroids.cpu().numpy().astype(np.float32)
    cb = index.codebooks.cpu().numpy().astype(np.float32)  # [M, ksub, dsub]
    M, ksub, dsub = cb.shape
    q = np.asarray(queries, np.float32)

    # client stage 3: probe ranking (probe₀ = nearest centroid)
    d2c = ((q[:, None, :] - cent[None]) ** 2).sum(-1)
    probe0 = np.argmin(d2c, axis=1)

    # client encode → server reconstruct (the codes adversary's view)
    if index.params.by_residual:
        r = q - cent[probe0]
    else:
        r = q
    rs = r.reshape(len(q), M, dsub)
    codes = np.argmin(
        ((rs[:, :, None, :] - cb[None]) ** 2).sum(-1), axis=-1
    )
    qhat = cb[np.arange(M)[None, :], codes].reshape(len(q), -1)
    if index.params.by_residual:
        qhat = qhat + cent[probe0]

    true_topk = _nn_topk(base, q, k)
    rep = CoarseLeakageReport(
        nq=len(q), code_bits=int(M * np.log2(ksub))
    )
    rep.adversaries["codes"] = _stats(base, q, qhat, true_topk, k)
    rep.adversaries["probes"] = _stats(
        base, q, cent[probe0], true_topk, k
    )
    return rep
