"""K2: the whole four-step NTT in one launch, on the int8 tensor cores.

Port of the TPU kernel prefhetch_tpu/ops/ntt_pallas.py ``_run_step``
(:246-287, body ``_make_kernel`` :169-243) together with the two-stage
composition around it (``ntt4_pallas``/``intt4_pallas``, :290-311).
``ntt4_transform(x, tb, inverse)`` computes ``ops/ntt4.ntt4`` (forward,
four-step order out) or ``intt4`` (inverse, natural order out) of [B, N]
int32 or int64 values (int64 by its low 32 bits): canonical [0, q), int32.

It picks by the device of ``x``: a CPU tensor takes the transform's plain
version (``ops/ntt4.transform_plain``: two ``ntt4_step_plain`` stages with
the transposes between them), a CUDA tensor launches the hand-written
kernel ``csrc/ntt4_step.cu`` (nvcc for sm_90a, bound with ctypes, built at
first use) or raises. There is no fallback from the kernel to the plain
version. ``ntt4_transform.launches`` counts kernel launches.

The kernel keeps the TPU kernel's arithmetic: each stage's input is folded
once and split into four balanced base-256 int8 digits, the tables are held
as their digit planes (``balanced_digits``, the port's copy of
``prefhetch_tpu/ops/ntt_mxu.py:57`` ``_balanced_digits_int``), the 16 digit
products run on the int8 tensor cores (``mma.sync`` m16n8k32) summed by
diagonal, and the TPU's group recombination, Shoup multiplies and
correction constant bring them back mod q. ``emulate_step`` and
``emulate_transform`` repeat that arithmetic in plain PyTorch integers, so
the CPU tests hold it bit-equal to the Pallas kernel before any card runs
it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_LIB = "ntt4_step"
_M30 = (1 << 30) - 1
_U32 = (1 << 32) - 1
N_DIGITS = 4
# the shapes the kernel takes: N = 64 x n2 (ops/ntt4.build_ntt4_tables)
N1 = 64
N2_TAKEN = (64, 128)


def balanced_digits(mat: np.ndarray) -> np.ndarray:
    """[..] int64 residues in [0, 2^31) → [4, ..] int8 balanced base-256
    digits, low digit first (the port's copy of ntt_mxu._balanced_digits_int)."""
    x = np.asarray(mat, np.int64).copy()
    out = np.empty((N_DIGITS,) + x.shape, np.int8)
    for d in range(N_DIGITS):
        r = ((x + 128) % 256) - 128
        out[d] = r.astype(np.int8)
        x = (x - r) >> 8
    assert np.all(x == 0), "digits must reconstruct exactly"
    return out


def shoup(c: int, q: int) -> int:
    """floor(c · 2^32 / q), the Shoup companion of a constant c < q."""
    return (c << 32) // q


def recombine_consts(q: int) -> np.ndarray:
    """The kernel's nine constants, as the TPU kernel derives them
    (ntt_pallas.py:175-183): q, δ = 2^30 − q, 2^16, 2^24 and 2^40 mod q each
    with its Shoup companion, and the correction −2^31·(1 + 2^16 + 2^24 +
    2^40) mod q of the top-bit flips."""
    w2, w34, w56 = pow(2, 16, q), pow(2, 24, q), pow(2, 40, q)
    corr = (-(1 << 31) * (1 + (1 << 16) + (1 << 24) + (1 << 40))) % q
    return np.array([q, (1 << 30) - q, w2, shoup(w2, q), w34, shoup(w34, q),
                     w56, shoup(w56, q), corr], np.uint32)


class FusedTables:
    """One direction's tables in the kernel's layout: the 64 x 64 table T1
    and the n2 x n2 table T2 as digit planes [4, rows, k] of M[row, k] (the
    matrices of ntt_mxu before their transposition into right-multiply
    form), and stage a's twiddles tw[j1, k2] interleaved with their Shoup
    companions as [64, n2/2, 4] uint32 (tw[c], tw[c+1], tws[c], tws[c+1])."""

    def __init__(self, tb, inverse: bool):
        if inverse:                                 # W1g, W2i, g_tw
            t1, t2 = tb.g_b.w.T, tb.g_a.w.T
            tw, tws = tb.g_a.tw, tb.g_a.tw_shoup
        else:                                       # W1f, W2, f_tw
            t1, t2 = tb.f_a.w.T, tb.f_b.w.T
            tw, tws = tb.f_a.tw.T, tb.f_a.tw_shoup.T
        self.q, self.n1, self.n2 = tb.q, tb.n1, tb.n2
        self.t1 = balanced_digits(t1)
        self.t2 = balanced_digits(t2)
        self.tw = np.ascontiguousarray(tw, np.int64)            # [n1, n2]
        self.tws = np.ascontiguousarray(tws, np.int64)
        pair = lambda a: a.reshape(self.n1, self.n2 // 2, 2)    # noqa: E731
        self.tw_packed = np.concatenate(
            [pair(self.tw), pair(self.tws)], axis=-1).astype(np.uint32)
        self.consts = recombine_consts(tb.q)
        self._dev: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(t1, t2, tw) on ``device``, made once; uint32 travels as int32."""
        t = self._dev.get(device)
        if t is None:
            t = (torch.from_numpy(self.t1.view(np.uint8)).to(device),
                 torch.from_numpy(self.t2.view(np.uint8)).to(device),
                 torch.from_numpy(self.tw_packed.view(np.int32)).to(device))
            self._dev[device] = t
        return t


@functools.lru_cache(maxsize=None)
def fused_tables(tb, inverse: bool) -> FusedTables:
    """One direction's kernel tables of ``ops/ntt4.build_ntt4_tables``'
    (itself cached) tables, made once."""
    return FusedTables(tb, bool(inverse))


# ---------------------------------------------------------------------------
# the kernel's arithmetic in plain PyTorch integers (int64 tensors holding
# u32 values), for the CPU tests


def _fold30(x: torch.Tensor, delta: int) -> torch.Tensor:
    return (x & _M30) + (x >> 30) * delta


def _shoup_mul(x, c, cs, q: int) -> torch.Tensor:
    """x·c − mulhi(x, cs)·q in wrapping u32 arithmetic: [0, 2q)."""
    h = ((x & 0xFFFF) * cs >> 16) + (x >> 16) * cs    # < 2^49: exact in int64
    return (x * c - (h >> 16) * q) & _U32


def lift(x: torch.Tensor, q: int) -> torch.Tensor:
    """The kernel's read of int32 or int64 input: the low 32 bits as a
    signed int32 (what ``.to(torch.int32)`` keeps), a negative value plus
    3q — a non-negative u32 of the same residue class, as int64."""
    s = x.to(torch.int32).to(torch.int64)
    return torch.where(s < 0, s + 3 * q, s)


def split_digits(x: torch.Tensor, delta: int) -> torch.Tensor:
    """The kernel's split of u32 values: fold30, then four balanced
    base-256 digits, [4, ...] int64 in [-128, 127]."""
    cur = _fold30(x.to(torch.int64) & _U32, delta)
    out = []
    for _ in range(N_DIGITS):
        r = ((cur + 128) & 255) - 128
        out.append(r)
        cur = (cur - r) >> 8
    return torch.stack(out)


def emulate_step(x: torch.Tensor, digits: np.ndarray, q: int,
                 tw: Optional[np.ndarray], tws: Optional[np.ndarray],
                 canonical: bool) -> torch.Tensor:
    """One stage as the kernel computes it, on the CPU:
    y[b, i, j] = Σ_k x[b, i, k]·M[j, k] (· tw[i, j]) mod q, with ``digits``
    the planes of M [4, J, K] and ``tws`` the twiddles' Shoup companions.
    The input's low 32 bits are folded and split, the 16 digit products
    summed by diagonal s = d + e (int32-exact), the
    diagonals recombined by the TPU kernel's groups, then the Shoup twiddle
    and, if ``canonical``, the final subtractions. Returns int64 values:
    [0, 2q) lazy, [0, q) canonical — the Pallas ``_run_step``'s own."""
    c = [int(v) for v in recombine_consts(q)]
    _, delta, w2c, w2s, w34c, w34s, w56c, w56s, corr = c
    xd = split_digits(x, delta)                          # [4, B, R, K]
    wd = torch.from_numpy(np.asarray(digits, np.int64))  # [4, J, K]
    a = [0] * 7
    for d in range(N_DIGITS):
        for e in range(N_DIGITS):
            a[d + e] = a[d + e] + torch.matmul(xd[d], wd[e].T)
    for s in range(7):
        assert int(a[s].abs().max()) < 1 << 23          # no int32 wrap
    g01 = (a[0] + (a[1] << 8)) & _U32
    g2 = a[2] & _U32
    g34 = (a[3] + (a[4] << 8)) & _U32
    g56 = (a[5] + (a[6] << 8)) & _U32
    top = 1 << 31
    r01 = _fold30(g01 ^ top, delta)
    r2 = _shoup_mul(g2 ^ top, w2c, w2s, q)
    r34 = _shoup_mul(g34 ^ top, w34c, w34s, q)
    r56 = _shoup_mul(g56 ^ top, w56c, w56s, q)
    t = _fold30(r2 + r34, delta)
    t2 = _fold30(r56 + corr, delta)
    v = _fold30(t + t2 + r01, delta)
    if tw is not None:
        v = _shoup_mul(v, torch.from_numpy(np.asarray(tw, np.int64)),
                       torch.from_numpy(np.asarray(tws, np.int64)), q)
    if canonical:
        v = torch.where(v >= q, v - q, v)
        v = torch.where(v >= q, v - q, v)
    return v


def emulate_transform(x: torch.Tensor, tb, inverse: bool) -> torch.Tensor:
    """The whole transform as the kernel runs it (stage a lazy, stage b
    canonical, the transposes folded into the splits), on the CPU: [B, N]
    int32 or int64 → [B, N] int32."""
    ft = fused_tables(tb, inverse)
    bsz = x.shape[0]
    xl = lift(x, tb.q)
    a = xl.reshape(bsz, tb.n1, tb.n2)
    if not inverse:
        # D[j1, k2] = Σ_k1 W1f[j1, k1]·a[k1, k2]: computed per element as
        # the stage over a's columns, then laid out [j1, k2]
        y = emulate_step(a.transpose(1, 2), ft.t1, tb.q, ft.tw.T, ft.tws.T,
                         False)
        z = emulate_step(y.transpose(1, 2), ft.t2, tb.q, None, None, True)
        return z.reshape(bsz, tb.n).to(torch.int32)
    y = emulate_step(a, ft.t2, tb.q, ft.tw, ft.tws, False)        # [j1, k2]
    z = emulate_step(y.transpose(1, 2), ft.t1, tb.q, None, None,
                     True)                                       # [k2, k1]
    return z.transpose(1, 2).reshape(bsz, tb.n).to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    fn = lib.pfh_ntt4_transform
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, i, i,
                   ctypes.POINTER(ctypes.c_uint), p]
    return lib


def check(x: torch.Tensor, tb) -> int:
    """What the kernel takes: [B, 64·n2] int32 or int64, contiguous, n2 in
    (64, 128), B > 0, δ = 2^30 − q < 2^20. Returns B."""
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"K2 takes int32 or int64 residues, got {x.dtype}")
    if x.dim() != 2 or tuple(x.shape[1:]) != (tb.n,) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, {tb.n}]")
    if tb.n1 != N1 or tb.n2 not in N2_TAKEN:
        raise ValueError(f"K2 takes N = 64 x n2 with n2 in {N2_TAKEN}, got "
                         f"{tb.n1} x {tb.n2}")
    if x.shape[0] == 0:
        raise ValueError("K2 takes a non-empty batch")
    if (1 << 30) - tb.q >= 1 << 20:
        raise ValueError(f"prime {tb.q} too far below 2^30 for the kernel's "
                         f"shift reduction")
    return x.shape[0]


def ntt4_transform(x: torch.Tensor, tb, inverse: bool) -> torch.Tensor:
    """K2 on x's device: the forward (``inverse=False``) or inverse
    four-step transform of [B, N] int32 or int64 values, any value taken as
    its residue mod q (int64 by its low 32 bits, as ``.to(torch.int32)`` and
    the plain version take it) → [B, N] int32 in [0, q)."""
    if x.device.type == "cpu":
        from prefhetch_tpu_torch.ops.ntt4 import transform_plain

        return transform_plain(x, tb, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu, not {x.device}")
    bsz = check(x, tb)
    lib = _library()
    ft = fused_tables(tb, inverse)
    t1, t2, tw = ft.on(x.device)
    consts = (ctypes.c_uint * len(ft.consts))(*[int(v) for v in ft.consts])
    with torch.cuda.device(x.device):
        out = torch.empty((bsz, tb.n), dtype=torch.int32, device=x.device)
        err = lib.pfh_ntt4_transform(
            x.data_ptr(), int(x.dtype == torch.int64), t1.data_ptr(),
            t2.data_ptr(), tw.data_ptr(), out.data_ptr(), bsz, tb.n2,
            int(bool(inverse)), consts,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntt4_transform kernel launch failed: cudaError "
                           f"{err}")
    ntt4_transform.launches += 1
    return out


ntt4_transform.launches = 0
