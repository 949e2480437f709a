"""The rotation step's modular arithmetic: the three kernels of one hybrid
key switch around K2's transforms (engine/hecompute.py ``key_switch`` and
``rotate_add``, the rotation step of the packed BFV, CKKS and PIR device
programs). With l active primes, the l + 1 primes of the extension basis
(the special prime p last), n_comp = l·⌈30/bits⌉ digit planes and σ a
signed automorphism (``signed_perm``):

- ``ks_digits(y1, perm, neg, qs, bits)``: the digit planes of σ(y1) [M, l,
  N] → [M·n_comp, N] int32, row m·n_comp + i·⌈30/bits⌉ + j the j-th
  ``bits``-bit digit of limb i, the layout K2's forward takes;
- ``ks_mac(d, kb, ka, q)``: the forward digits d [M·n_comp, N] mod q times
  the key's rows kb, ka [n_comp, N] of that prime, summed over the digits
  → [2M, N] int32 canonical, the kb sums in rows [0, M) and the ka sums in
  [M, 2M): the layout K2's inverse takes;
- ``ks_finish(parts, x0, x1, y0, perm, neg, qs, p)``: the l + 1 inverses
  [2M, N] int32, the special prime's residue centred and divided out
  exactly, added to x → (x0 + σ(y0) + ks0, x1 + ks1) mod q in x's storage
  dtype.

x, y [M, l, N] hold canonical residues in one storage dtype, int32 (PIR) or
int64 (the packed and CKKS programs); perm int64 and neg bool [N] are one
row of ``hecompute.automorphism_tables``.

No TPU kernel stands behind them: the JAX key switch is ``jnp``. Each
wrapper picks by the device of its tensors: CPU tensors take the plain
version (``ks_digits_plain``, ``ks_mac_plain``, ``ks_finish_plain``: the
eager int64 arithmetic the rotation step ran before), CUDA tensors launch
the hand-written kernel of ``csrc/key_switch.cu`` (nvcc for sm_90a, bound
with ctypes, built at first use) or raise. There is no fallback from a
kernel to its plain version. Each wrapper's ``.launches`` counts its
kernel's launches and each plain version's ``.calls`` its own calls; inside
``record_stages()`` a launch also counts ``he.ks.launches`` on the
innermost open span.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from prefhetch_tpu_torch.ops.ntt4 import modmul
from prefhetch_tpu_torch.utils.stages import count

_LIB = "key_switch"
# the kernels' constants (csrc/key_switch.cu): products summed between the
# mac's lazy folds, the most extension primes, the widest ring
SPAN = 14
MAX_PRIMES = 8
MAX_N = 8192
_STORAGE = (torch.int32, torch.int64)


def signed_perm(x: torch.Tensor, perm: torch.Tensor, neg: torch.Tensor,
                qs: torch.Tensor) -> torch.Tensor:
    """[..., l, N] canonical residues → out[..., i] = ±x[..., perm[i]] mod
    q, negated where ``neg``, in the dtype of x and qs [l, 1]."""
    y = x[..., perm]
    return torch.where(neg & (y != 0), qs - y, y)


def _qcol(qs: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([int(q) for q in qs], dtype=like.dtype,
                        device=like.device)[:, None]


def n_digits(bits: int) -> int:
    return -(-30 // bits)


# ---------------------------------------------------------------------------
# the plain versions


def ks_digits_plain(y: torch.Tensor, perm: torch.Tensor, neg: torch.Tensor,
                    qs: Sequence[int], bits: int) -> torch.Tensor:
    """The digit planes in plain PyTorch: the signed gather, one shift and
    mask a digit, stacked."""
    ks_digits_plain.calls += 1
    M, l, n = y.shape
    g = signed_perm(y, perm, neg, _qcol(qs, y))
    mask = (1 << bits) - 1
    return torch.stack([(g[:, i] >> (j * bits)) & mask for i in range(l)
                        for j in range(n_digits(bits))], 1) \
        .reshape(-1, n).to(torch.int32)


ks_digits_plain.calls = 0


def ks_mac_plain(d: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
                 q: int) -> torch.Tensor:
    """The key's digit products in plain PyTorch: two int64 products of
    every digit, each summed over the digits and reduced."""
    ks_mac_plain.calls += 1
    n_comp, n = kb.shape
    D = d.reshape(-1, n_comp, n)
    s0 = modmul(D, kb, q).sum(1) % q
    s1 = modmul(D, ka, q).sum(1) % q
    return torch.cat([s0, s1]).to(torch.int32)


ks_mac_plain.calls = 0


def ks_finish_plain(parts: Sequence[torch.Tensor], x0: torch.Tensor,
                    x1: torch.Tensor, y0: torch.Tensor, perm: torch.Tensor,
                    neg: torch.Tensor, qs: Sequence[int],
                    p: int) -> tuple:
    """The division and the sums in plain PyTorch, int64: the special
    prime's residue centred, ``%`` by each prime, then the adds."""
    ks_finish_plain.calls += 1
    M = x0.shape[0]
    acc = [a.to(torch.int64) for a in parts]
    cp = torch.where(acc[-1] > p // 2, acc[-1] - p, acc[-1])
    ks = torch.stack([(acc[i] - cp) % q * pow(p, -1, q) % q
                      for i, q in enumerate(qs)], 1)          # [2M, l, N]
    qcol = _qcol(qs, ks)
    g0 = signed_perm(y0, perm, neg, _qcol(qs, y0))
    z0 = (x0.to(torch.int64) + g0 + ks[:M]) % qcol
    z1 = (x1.to(torch.int64) + ks[M:]) % qcol
    return z0.to(x0.dtype), z1.to(x1.dtype)


ks_finish_plain.calls = 0


# ---------------------------------------------------------------------------
# what the kernels take


def _same_device(*ts: torch.Tensor) -> None:
    for t in ts[1:]:
        if t.device != ts[0].device:
            raise ValueError(f"tensors on {ts[0].device} and {t.device}")


def _check_moduli(qs: Sequence[int]) -> None:
    if any(not 1 < int(q) < 1 << 30 for q in qs):
        raise ValueError(f"moduli must lie in (1, 2^30), got {list(qs)}")


def _check_automorphism(perm: torch.Tensor, neg: torch.Tensor,
                        n: int) -> None:
    if perm.dtype != torch.int64 or tuple(perm.shape) != (n,) \
            or not perm.is_contiguous():
        raise ValueError(f"perm must be a contiguous int64 [{n}], got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if neg.dtype != torch.bool or tuple(neg.shape) != (n,) \
            or not neg.is_contiguous():
        raise ValueError(f"neg must be a contiguous bool [{n}], got "
                         f"{neg.dtype} {tuple(neg.shape)}")


def _check_rows(name: str, t: torch.Tensor, qs: Sequence[int]) -> tuple:
    """[M, l, N] contiguous int32 or int64, one modulus a limb."""
    if t.dtype not in _STORAGE:
        raise ValueError(f"{name} must be int32 or int64 residues, got "
                         f"{t.dtype}")
    if t.dim() != 3 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [M, l, N], got "
                         f"{tuple(t.shape)}")
    M, l, n = t.shape
    if M < 1 or not 1 <= l < MAX_PRIMES or not 1 <= n <= MAX_N \
            or len(qs) != l:
        raise ValueError(f"{name} [{M}, {l}, {n}]: the kernels take M > 0, "
                         f"1 to {MAX_PRIMES - 1} limbs with one modulus each "
                         f"({len(qs)} given) and N up to {MAX_N}")
    _check_moduli(qs)
    return M, l, n


def check_digits(y: torch.Tensor, perm: torch.Tensor, neg: torch.Tensor,
                 qs: Sequence[int], bits: int) -> tuple:
    """What ``ks_digits`` takes, besides the device: y a contiguous [M, l,
    N] int32 or int64, 1 to 7 limbs, N up to 8192, its moduli in (1, 2^30),
    1 ≤ bits ≤ 30, the automorphism [N]. Returns (M, l, N)."""
    _same_device(y, perm, neg)
    M, l, n = _check_rows("y", y, qs)
    _check_automorphism(perm, neg, n)
    if not 1 <= bits <= 30:
        raise ValueError(f"digit width {bits} outside [1, 30]")
    return M, l, n


def check_mac(d: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
              q: int) -> tuple:
    """What ``ks_mac`` takes, besides the device: d a contiguous [M·n_comp,
    N] int32, kb and ka [n_comp, N] int32 with unit stride along N (any row
    stride: a prime's rows of a key stack), q in (1, 2^30). Returns (M,
    n_comp, N)."""
    _same_device(d, kb, ka)
    for name, t in (("d", d), ("kb", kb), ("ka", ka)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 residues, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    n_comp, n = kb.shape
    if tuple(ka.shape) != (n_comp, n) or d.shape[1] != n or n_comp < 1 \
            or d.shape[0] % n_comp or d.shape[0] == 0:
        raise ValueError(f"d {tuple(d.shape)}, kb {tuple(kb.shape)} and ka "
                         f"{tuple(ka.shape)} do not match: want [M·n_comp, "
                         f"N], [n_comp, N] twice")
    if not d.is_contiguous() or kb.stride(1) != 1 or ka.stride(1) != 1:
        raise ValueError("d must be contiguous and kb, ka contiguous along N")
    _check_moduli([q])
    return d.shape[0] // n_comp, n_comp, n


def check_finish(parts: Sequence[torch.Tensor], x0: torch.Tensor,
                 x1: torch.Tensor, y0: torch.Tensor, perm: torch.Tensor,
                 neg: torch.Tensor, qs: Sequence[int], p: int) -> tuple:
    """What ``ks_finish`` takes, besides the device: x0, x1, y0 contiguous
    [M, l, N] in one storage dtype (as ``check_digits``'s y), l + 1
    contiguous int32 parts [2M, N], moduli and p in (1, 2^30). Returns
    (M, l, N)."""
    _same_device(x0, x1, y0, perm, neg, *parts)
    M, l, n = _check_rows("x0", x0, qs)
    for name, t in (("x1", x1), ("y0", y0)):
        if t.dtype != x0.dtype or t.shape != x0.shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} does not "
                             f"match x0 {x0.dtype} {tuple(x0.shape)}")
    _check_automorphism(perm, neg, n)
    if len(parts) != l + 1 or any(
            a.dtype != torch.int32 or tuple(a.shape) != (2 * M, n)
            or not a.is_contiguous() for a in parts):
        raise ValueError(f"parts must be {l + 1} contiguous int32 "
                         f"[{2 * M}, {n}]")
    _check_moduli([p])
    return M, l, n


# ---------------------------------------------------------------------------
# the kernels


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    p, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
    lib.pfh_ks_digits.argtypes = [p, i, p, p, p, i, i, i, i,
                                  ctypes.POINTER(u), p]
    lib.pfh_ks_mac.argtypes = [p, p, p, ll, ll, p, i, i, i, u, u,
                               ctypes.c_ulonglong, p]
    lib.pfh_ks_finish.argtypes = [ctypes.POINTER(p), p, p, p, i, p, p, p, p,
                                  i, i, i, ctypes.POINTER(u), u, p]
    for fn in (lib.pfh_ks_digits, lib.pfh_ks_mac, lib.pfh_ks_finish):
        fn.restype = ctypes.c_int
    return lib


def _on_card(dev: torch.device, what: str) -> bool:
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return True


def _launched(err: int, wrapper, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    wrapper.launches += 1
    count("he.ks.launches", 1)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def ks_digits(y: torch.Tensor, perm: torch.Tensor, neg: torch.Tensor,
              qs: Sequence[int], bits: int) -> torch.Tensor:
    """The digit planes of σ(y) on y's device: [M·n_comp, N] int32 (plain
    version on the CPU, the kernel on the card)."""
    M, l, n = check_digits(y, perm, neg, qs, bits)
    if not _on_card(y.device, "ks_digits"):
        return ks_digits_plain(y, perm, neg, qs, bits)
    lib = _library()
    moduli = (ctypes.c_uint * l)(*[int(q) for q in qs])
    with torch.cuda.device(y.device):
        out = torch.empty((M * l * n_digits(bits), n), dtype=torch.int32,
                          device=y.device)
        err = lib.pfh_ks_digits(
            y.data_ptr(), int(y.dtype == torch.int64), perm.data_ptr(),
            neg.data_ptr(), out.data_ptr(), M, l, n, bits, moduli,
            _stream(y.device))
    _launched(err, ks_digits, "ks_digits")
    return out


ks_digits.launches = 0


def ks_mac(d: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
           q: int) -> torch.Tensor:
    """Both halves' digit sums mod q on d's device: [2M, N] int32 canonical
    (plain version on the CPU, the kernel on the card)."""
    M, n_comp, n = check_mac(d, kb, ka, q)
    if not _on_card(d.device, "ks_mac"):
        return ks_mac_plain(d, kb, ka, q)
    lib = _library()
    q = int(q)
    with torch.cuda.device(d.device):
        out = torch.empty((2 * M, n), dtype=torch.int32, device=d.device)
        err = lib.pfh_ks_mac(
            d.data_ptr(), kb.data_ptr(), ka.data_ptr(), kb.stride(0),
            ka.stride(0), out.data_ptr(), M, n_comp, n, q, (1 << 32) % q,
            (1 << 64) // q, _stream(d.device))
    _launched(err, ks_mac, "ks_mac")
    return out


ks_mac.launches = 0


def finish_consts(qs: Sequence[int], p: int) -> List[int]:
    """The finish kernel's [4, l] constants: each q_i, p^-1 mod q_i, its
    Shoup constant ⌊p^-1·2^32 / q_i⌋ and the least multiple of q_i not
    below p."""
    qs = [int(q) for q in qs]
    inv = [pow(p, -1, q) for q in qs]
    return (qs + inv + [(v << 32) // q for v, q in zip(inv, qs)]
            + [q * -(-p // q) for q in qs])


def ks_finish(parts: Sequence[torch.Tensor], x0: torch.Tensor,
              x1: torch.Tensor, y0: torch.Tensor, perm: torch.Tensor,
              neg: torch.Tensor, qs: Sequence[int], p: int) -> tuple:
    """(x0 + σ(y0) + ks0, x1 + ks1) mod q on x's device, in x's shape and
    dtype (plain version on the CPU, the kernel on the card)."""
    M, l, n = check_finish(parts, x0, x1, y0, perm, neg, qs, p)
    if not _on_card(x0.device, "ks_finish"):
        return ks_finish_plain(parts, x0, x1, y0, perm, neg, qs, p)
    lib = _library()
    consts = finish_consts(qs, int(p))
    ptrs = (ctypes.c_void_p * (l + 1))(*[a.data_ptr() for a in parts])
    with torch.cuda.device(x0.device):
        z0 = torch.empty_like(x0)
        z1 = torch.empty_like(x1)
        err = lib.pfh_ks_finish(
            ptrs, x0.data_ptr(), x1.data_ptr(), y0.data_ptr(),
            int(x0.dtype == torch.int64), perm.data_ptr(), neg.data_ptr(),
            z0.data_ptr(), z1.data_ptr(), M, l, n,
            (ctypes.c_uint * len(consts))(*consts), int(p),
            _stream(x0.device))
    _launched(err, ks_finish, "ks_finish")
    return z0, z1


ks_finish.launches = 0
