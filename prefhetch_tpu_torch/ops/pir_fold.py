"""The PIR dim-1 fold: every selector set of a program folded against one
pass over the packed database (engine/pir_device.py ``DevicePIR2``). For
each limb l and NTT coefficient n:

    out[s, c, j, l, n] = Σ_i s1[s, i, c, l, n] · db[i, j, l, n]  mod q_l

``s1`` [S, rows, 2, L, N] and ``db`` [rows, g2, L, N] are int32 canonical
residues, contiguous in their inner three dims with any outer strides (the
view ``sel[:, :g1]`` and a shard ``db[a:b]`` are taken as they are, without
a copy); ``out`` [S, 2, g2, L, N] is int32 canonical, each value in
[0, q_l).

No TPU kernel stands behind it: the JAX program's fold is a ``lax.scan`` of
``modmul``s (prefhetch_tpu/engine/pir_device.py:454-479). ``fold_dim1``
picks by the device of its tensors: CPU tensors take the plain version
(``fold_dim1_plain``: one int64 ``addcmul_`` a database row, reduced every
seven), CUDA tensors launch the hand-written kernel ``csrc/pir_fold1.cu``
(nvcc for sm_90a, bound with ctypes, built at first use) or raise. There is
no fallback from the kernel to the plain version. ``fold_dim1.launches``
counts kernel launches, ``fold_dim1_plain.calls`` plain-version calls;
inside ``record_stages()`` a launch also counts ``pir.fold1.launches`` on
the innermost open span.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from prefhetch_tpu_torch.utils.stages import count

_LIB = "pir_fold1"
# products < q² < 2^60: seven of them and a residue < q stay below 2^63
_SUMS_PER_REDUCE = 7
# the kernel's constants (csrc/pir_fold1.cu): products summed between its
# lazy folds, and the most limbs it takes
SPAN = 14
MAX_LIMBS = 8


def fold_dim1_plain(s1: torch.Tensor, db: torch.Tensor,
                    qs: Sequence[int]) -> torch.Tensor:
    """The fold in plain PyTorch on the tensors' device: an int64
    accumulator, one ``addcmul_`` a database row, reduced mod q every
    seven rows and after the last; canonical int32 out."""
    fold_dim1_plain.calls += 1
    S, rows = s1.shape[:2]
    q = torch.tensor(list(qs), dtype=torch.int64, device=db.device)[:, None]
    acc = torch.zeros((S, 2, db.shape[1]) + tuple(db.shape[2:]),
                      dtype=torch.int64, device=db.device)
    for i in range(rows):
        acc.addcmul_(s1[:, i, :, None], db[i])
        if (i + 1) % _SUMS_PER_REDUCE == 0 or i + 1 == rows:
            acc %= q
    return acc.to(torch.int32)


fold_dim1_plain.calls = 0


def check(s1: torch.Tensor, db: torch.Tensor, qs: Sequence[int]) -> tuple:
    """What the fold takes (see the module's docstring), besides the
    device: S, rows, g2 > 0, N a multiple of 32, 1 to 8 limbs, each
    modulus in (1, 2^30), g2·L·N below 2^31. Returns (S, rows, g2, L, N)."""
    if s1.device != db.device:
        raise ValueError(f"s1 is on {s1.device}, db on {db.device}")
    for name, t in (("s1", s1), ("db", db)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 residues, got {t.dtype}")
    if s1.dim() != 5 or s1.shape[2] != 2:
        raise ValueError(f"s1 must be [S, rows, 2, L, N], got "
                         f"{tuple(s1.shape)}")
    if db.dim() != 4:
        raise ValueError(f"db must be [rows, g2, L, N], got "
                         f"{tuple(db.shape)}")
    S, rows, _, L, N = s1.shape
    g2 = db.shape[1]
    if db.shape[0] != rows or tuple(db.shape[2:]) != (L, N):
        raise ValueError(f"db {tuple(db.shape)} does not match s1 "
                         f"{tuple(s1.shape)}: want [{rows}, g2, {L}, {N}]")
    if min(S, rows, g2) == 0:
        raise ValueError("the fold takes S, rows and g2 above 0")
    if N % 32 or not 1 <= L <= MAX_LIMBS or len(qs) != L:
        raise ValueError(f"the fold takes N a multiple of 32 and 1 to "
                         f"{MAX_LIMBS} limbs, one modulus each: N={N}, "
                         f"L={L}, {len(qs)} moduli")
    if any(not 1 < int(q) < 1 << 30 for q in qs):
        raise ValueError(f"moduli must lie in (1, 2^30), got {list(qs)}")
    if tuple(s1.stride()[2:]) != (L * N, N, 1) \
            or tuple(db.stride()[1:]) != (L * N, N, 1):
        raise ValueError("s1 and db must be contiguous in their last three "
                         "dims")
    if g2 * L * N >= 1 << 31:
        raise ValueError(f"a database row of {g2 * L * N} residues exceeds "
                         f"2^31")
    return S, rows, g2, L, N


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    fn = lib.pfh_pir_fold1
    fn.restype = ctypes.c_int
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, i, i, i, i, i, ll, ll, ll,
                   ctypes.POINTER(ctypes.c_uint), p]
    return lib


def fold_dim1(s1: torch.Tensor, db: torch.Tensor,
              qs: Sequence[int]) -> torch.Tensor:
    """The dim-1 fold on the tensors' device: [S, 2, g2, L, N] int32
    canonical residues (plain version on the CPU, the kernel on the card)."""
    S, rows, g2, L, N = check(s1, db, qs)
    if db.device.type == "cpu":
        return fold_dim1_plain(s1, db, qs)
    if db.device.type != "cuda":
        raise ValueError(f"the fold runs on cuda or cpu, not {db.device}")
    lib = _library()
    moduli = (ctypes.c_uint * L)(*[int(q) for q in qs])
    with torch.cuda.device(db.device):
        out = torch.empty((S, 2, g2, L, N), dtype=torch.int32,
                          device=db.device)
        err = lib.pfh_pir_fold1(
            s1.data_ptr(), db.data_ptr(), out.data_ptr(), S, rows, g2, L, N,
            s1.stride(0), s1.stride(1), db.stride(0), moduli,
            torch.cuda.current_stream(db.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pir_fold1 kernel launch failed: cudaError {err}")
    fold_dim1.launches += 1
    count("pir.fold1.launches", 1)
    return out


fold_dim1.launches = 0
