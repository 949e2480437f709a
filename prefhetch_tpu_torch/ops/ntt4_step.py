"""K2: one stage of the four-step negacyclic NTT.

Port of the TPU kernel prefhetch_tpu/ops/ntt_pallas.py ``_run_step``
(:246-287, kernel body ``_make_kernel`` :169-243). One stage is a modular
matrix product over the last axis, an optional twiddle multiply, and an
optional canonicalisation:

    y[b, i, j] = ((Σ_k x[b, i, k] · W[k, j]) · tw[i, j]) mod q

x is ``[B, r, m]`` int32 (any int32 value is taken as its residue mod q; the
callers feed ``[0, 2^31)``), W is ``[m, m]`` residues in right-multiply form,
tw ``[r, m]`` residues with their Shoup companions ``floor(tw·2^32/q)``. The
result is int32, congruent to the formula mod q, in ``[0, q)`` when
``canonical`` and in ``[0, 2q)`` (below 2^31) otherwise. The lazy range is
each implementation's own: the plain version always returns ``[0, q)``.

``ntt4_step`` picks by the device of ``x``: a CPU tensor takes the plain
PyTorch version (``ntt4_step_plain``), a CUDA tensor launches the
hand-written kernel ``csrc/ntt4_step.cu`` (nvcc for sm_90a, bound with
ctypes, built at first use) or raises. There is no fallback from the kernel
to the plain version. ``ntt4_step.launches`` counts kernel launches and
``ntt4_step_plain.calls`` counts plain-version calls.

The TPU kernel splits x and W into four balanced int8 digits (its matrix
unit multiplies nothing wider) and pads the batch to 32 rows for its grid;
neither carries over: the card multiplies 32×32→64 bits natively and a block
owns one polynomial.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_LIB = "ntt4_step"
# shared memory a block may use on Hopper (dynamic, after opt-in)
_SMEM_MAX = 232448


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
        """The stage's tensors on ``device``, made once. uint32 tables travel
        as int32 bit patterns (every torch build moves int32)."""
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
            if device.type == "cuda":
                t["w_u32"] = torch.from_numpy(
                    self.w.astype(np.uint32).view(np.int32)).to(device)
                if self.tw is not None:
                    t["tw_u32"] = torch.from_numpy(
                        self.tw.astype(np.uint32).view(np.int32)).to(device)
                    t["tws_u32"] = torch.from_numpy(
                        self.tw_shoup.view(np.int32)).to(device)
            self._dev[device] = t
        return t


def ntt4_step_plain(x: torch.Tensor, step: NTT4Step) -> torch.Tensor:
    """Plain PyTorch version of K2 on x's device; always returns [0, q),
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


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    fn = lib.pfh_ntt4_step
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,              # x, w
        ctypes.c_void_p, ctypes.c_void_p,              # tw, tw_shoup (or 0)
        ctypes.c_void_p,                               # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,      # B, r, m
        ctypes.c_uint, ctypes.c_int,                   # q, canonical
        ctypes.c_void_p,                               # stream
    ]
    return lib


def smem_bytes(r: int, m: int) -> int:
    """Dynamic shared memory of one block: W [m, m] and x [r, m], 4 B each."""
    return 4 * (m * m + r * m)


def _check(x: torch.Tensor, step: NTT4Step) -> Tuple[int, int, int]:
    if x.dtype != torch.int32:
        raise ValueError(f"K2 takes int32 residues, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [B, r, m]")
    B, r, m = x.shape
    if m != step.m or r != step.r:
        raise ValueError(
            f"x is [B, {r}, {m}] but the stage's tables are for "
            f"[B, {step.r}, {step.m}]")
    if m not in (64, 128):
        raise ValueError(f"K2 takes m in (64, 128), got m={m}")
    if B == 0:
        raise ValueError("K2 takes a non-empty batch")
    if smem_bytes(r, m) > _SMEM_MAX:
        raise ValueError(
            f"[{r}, {m}] needs {smem_bytes(r, m)} B of shared memory, a "
            f"block has {_SMEM_MAX}")
    if (1 << 30) - step.q >= 1 << 20:
        raise ValueError(f"prime {step.q} too far below 2^30 for the "
                         f"kernel's shift reduction")
    return B, r, m


def ntt4_step(x: torch.Tensor, step: NTT4Step,
              canonical: bool = True) -> torch.Tensor:
    """K2 on x's device: [B, r, m] int32 → [B, r, m] int32."""
    if x.device.type == "cpu":
        return ntt4_step_plain(x, step)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu, not {x.device}")
    B, r, m = _check(x, step)
    lib = _library()
    t = step.on(x.device)
    has_tw = step.tw is not None
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pfh_ntt4_step(
            x.data_ptr(), t["w_u32"].data_ptr(),
            t["tw_u32"].data_ptr() if has_tw else None,
            t["tws_u32"].data_ptr() if has_tw else None,
            out.data_ptr(), B, r, m, step.q, int(bool(canonical)), stream,
        )
    if err != 0:
        raise RuntimeError(f"ntt4_step kernel launch failed: cudaError {err}")
    ntt4_step.launches += 1
    return out


ntt4_step.launches = 0
