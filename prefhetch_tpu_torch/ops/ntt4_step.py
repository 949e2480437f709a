"""One stage of the four-step negacyclic NTT: the tables and the plain
PyTorch version of the TPU kernel prefhetch_tpu/ops/ntt_pallas.py
``_run_step`` (:246-287, kernel body ``_make_kernel`` :169-243). One stage
is a modular matrix product over the last axis, an optional twiddle
multiply, and an optional canonicalisation:

    y[b, i, j] = ((Σ_k x[b, i, k] · W[k, j]) · tw[i, j]) mod q

x is ``[B, r, m]`` int32 (any int32 value is taken as its residue mod q; the
callers feed ``[0, 2^31)``), W is ``[m, m]`` residues in right-multiply form,
tw ``[r, m]`` residues with their Shoup companions ``floor(tw·2^32/q)``. The
result is int32, congruent to the formula mod q, in ``[0, q)`` when
``canonical`` and in ``[0, 2q)`` (below 2^31) otherwise. The lazy range is
each implementation's own: the plain version always returns ``[0, q)``.

Two such stages with the transposes between them are the plain version of
kernel K2 (``ops/ntt4.transform_plain``); the kernel itself computes the
whole transform in one launch (``ops/ntt4_fused.py``, ``csrc/ntt4_step.cu``).
``ntt4_step_plain.calls`` counts plain-stage calls.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class NTT4Step:
    """Tables of one stage: W ``[m, m]`` and twiddles ``[r, m]`` (or None)
    as numpy int64 residues in [0, q), plus their tensors on each device
    that has used them."""

    def __init__(self, q: int, w: np.ndarray, tw: Optional[np.ndarray],
                 r: int):
        m = w.shape[0]
        assert w.shape == (m, m) and (tw is None or tw.shape == (r, m))
        assert 0 <= int(w.min()) and int(w.max()) < q < 1 << 30
        self.q, self.r, self.m = int(q), int(r), int(m)
        self.w = np.ascontiguousarray(w, np.int64)
        self.tw = None if tw is None else np.ascontiguousarray(tw, np.int64)
        self._dev: Dict[torch.device, dict] = {}

    @property
    def tw_shoup(self) -> Optional[np.ndarray]:
        """floor(tw · 2^32 / q) as uint32 — the Shoup companions."""
        if self.tw is None:
            return None
        # tw < q < 2^30: tw << 32 overflows int64, so go through Python ints
        flat = [(int(c) << 32) // self.q for c in self.tw.reshape(-1)]
        return np.array(flat, np.uint64).astype(np.uint32).reshape(
            self.tw.shape)

    def on(self, device: torch.device) -> dict:
        """The plain version's tensors on ``device``, made once."""
        t = self._dev.get(device)
        if t is None:
            t = {
                # 15-bit halves of W as float64, for the plain version
                "w_lo": torch.from_numpy((self.w & 0x7FFF).astype(np.float64)
                                         ).to(device),
                "w_hi": torch.from_numpy((self.w >> 15).astype(np.float64)
                                         ).to(device),
                "tw": None if self.tw is None
                else torch.from_numpy(self.tw).to(device),
            }
            self._dev[device] = t
        return t


def ntt4_step_plain(x: torch.Tensor, step: NTT4Step) -> torch.Tensor:
    """One stage in plain PyTorch on x's device; always returns [0, q),
    which satisfies the canonical and the lazy contract alike.

    Exact without a wide integer product: x is reduced to [0, q) (< 2^30) and
    W is split into 15-bit halves W = W_hi·2^15 + W_lo. A product x·W_half is
    below 2^45 and any partial sum of m ≤ 128 of them is below 2^52 < 2^53,
    so float64 holds every partial sum of ``x @ W_half`` exactly, whatever
    order the matrix product adds in. The halves recombine and the twiddle
    multiplies in int64 (products < 2^60), reduced with ``%``."""
    ntt4_step_plain.calls += 1
    q = step.q
    t = step.on(x.device)
    xr = torch.remainder(x.to(torch.int64), q).to(torch.float64)
    lo = torch.matmul(xr, t["w_lo"]).to(torch.int64)
    hi = torch.matmul(xr, t["w_hi"]).to(torch.int64)
    y = (lo % q + ((hi % q) << 15)) % q
    if t["tw"] is not None:
        y = y * t["tw"] % q
    return y.to(torch.int32)


ntt4_step_plain.calls = 0
