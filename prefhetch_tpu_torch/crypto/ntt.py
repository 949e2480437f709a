"""Negacyclic number-theoretic transform over Z_q[X]/(X^N+1), on the host.

The port of prefhetch_tpu/crypto/ntt.py. ``ntt`` and ``intt`` are every
host transform of the port (the clients' keygen, encrypt and decrypt, the
server's ``ct_from_wire``, key tables, the host twins): each runs the C++
Shoup transform of native/host_lib.cpp (``native.NativeNTT``, one per
prime, size and direction, made once and shared by every thread). It takes
any int64 value as its residue mod q and returns canonical int64 in the
input's shape, natural order. A failed build of the library raises; there
is no switch back to numpy. The JAX module also traces this code under jit;
the port's device transform is ops/ntt4.py (kernel K2).

``ntt_plain`` and ``intt_plain`` keep the numpy butterfly as the oracle
the native transform and K2 are held against:

- One precomputed bit-reversal permutation up front, then log2(N) stages of
  reshapes + elementwise modular arithmetic over the whole [batch, N] array.
- Modular products run in int64 (operands < 2^31 ⇒ products < 2^62; an
  input beyond ±2^32 overflows the first product, where the native
  transform stays exact).
- The negacyclic twist (multiply by ψ^i / ψ^{-i}) is folded around a standard
  cyclic NTT with ω = ψ². Output is in natural order.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np

from prefhetch_tpu_torch import native
from prefhetch_tpu_torch.crypto.params import root_of_unity


class NTTTables(NamedTuple):
    """Precomputed constants for one prime q (all numpy int64, host-built)."""

    q: int
    n: int
    psi_pows: np.ndarray       # [n] ψ^i — forward twist
    ipsi_pows: np.ndarray      # [n] ψ^{-i}·n^{-1} (inverse twist, 1/n folded)
    stage_tw: Tuple[np.ndarray, ...]    # per-stage twiddles ω^…, shapes [m]
    stage_itw: Tuple[np.ndarray, ...]   # inverse-stage twiddles
    bitrev: np.ndarray         # [n] bit-reversal permutation


@functools.lru_cache(maxsize=None)
def build_tables(q: int, n: int) -> NTTTables:
    logn = n.bit_length() - 1
    assert 1 << logn == n
    psi = root_of_unity(q, 2 * n)
    omega = psi * psi % q
    inv_psi = pow(psi, -1, q)
    inv_omega = pow(omega, -1, q)
    inv_n = pow(n, -1, q)

    psi_pows = np.array([pow(psi, i, q) for i in range(n)], np.int64)
    ipsi = np.array([pow(inv_psi, i, q) * inv_n % q for i in range(n)], np.int64)

    bitrev = np.zeros(n, np.int64)
    for i in range(n):
        r = 0
        x = i
        for _ in range(logn):
            r = (r << 1) | (x & 1)
            x >>= 1
        bitrev[i] = r

    stage_tw = []
    stage_itw = []
    for s in range(logn):
        m = 1 << s  # half-block size at this stage
        w = pow(omega, n // (2 * m), q)
        iw = pow(inv_omega, n // (2 * m), q)
        stage_tw.append(np.array([pow(w, j, q) for j in range(m)], np.int64))
        stage_itw.append(np.array([pow(iw, j, q) for j in range(m)], np.int64))
    return NTTTables(
        q=q, n=n, psi_pows=psi_pows, ipsi_pows=ipsi,
        stage_tw=tuple(stage_tw), stage_itw=tuple(stage_itw), bitrev=bitrev,
    )


def _cyclic_ntt_core(x: np.ndarray, tables: NTTTables, inverse: bool):
    """In-order → in-order cyclic NTT over the last axis. x int64 in [0, q)."""
    q = tables.q
    n = tables.n
    logn = n.bit_length() - 1
    batch = x.shape[:-1]

    x = x[..., tables.bitrev]
    tws = tables.stage_itw if inverse else tables.stage_tw
    for s in range(logn):
        m = 1 << s
        y = x.reshape(*batch, n // (2 * m), 2, m)
        even = y[..., 0, :]
        odd = y[..., 1, :] * tws[s] % q              # int64 product < 2^61
        x = np.concatenate([(even + odd) % q, (even - odd) % q], axis=-1)
        x = x.reshape(*batch, n)
    return x


def ntt_plain(x: np.ndarray, tables: NTTTables) -> np.ndarray:
    """Forward negacyclic NTT along the last axis, numpy butterfly."""
    x = np.asarray(x, np.int64)
    return _cyclic_ntt_core(x * tables.psi_pows % tables.q, tables,
                            inverse=False)


def intt_plain(x: np.ndarray, tables: NTTTables) -> np.ndarray:
    """Inverse negacyclic NTT along the last axis, numpy butterfly."""
    y = _cyclic_ntt_core(np.asarray(x, np.int64), tables, inverse=True)
    return y * tables.ipsi_pows % tables.q


_native_lock = threading.Lock()
_native_ntts: Dict[tuple, native.NativeNTT] = {}


def _native(tables: NTTTables, inverse: bool) -> native.NativeNTT:
    key = (tables.q, tables.n, inverse)
    fn = _native_ntts.get(key)
    if fn is None:
        with _native_lock:
            fn = _native_ntts.get(key)
            if fn is None:
                fn = native.NativeNTT(tables, inverse=inverse)
                _native_ntts[key] = fn
    return fn


def ntt(x: np.ndarray, tables: NTTTables) -> np.ndarray:
    """Forward negacyclic NTT along the last axis (native; any int64 value
    taken as its residue mod q) → canonical int64."""
    return _native(tables, inverse=False)(x)


def intt(x: np.ndarray, tables: NTTTables) -> np.ndarray:
    """Inverse negacyclic NTT along the last axis (native)."""
    return _native(tables, inverse=True)(x)


def negacyclic_polymul(a: np.ndarray, b: np.ndarray,
                       tables: NTTTables) -> np.ndarray:
    """a·b in Z_q[X]/(X^N+1) via NTT ∘ pointwise ∘ INTT."""
    q = tables.q
    return intt(ntt(a, tables) * ntt(b, tables) % q, tables)


def naive_negacyclic_polymul(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """O(N²) schoolbook negacyclic product — test oracle."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            v = ai * int(b[j])
            if k < n:
                out[k] = (out[k] + v) % q
            else:
                out[k - n] = (out[k - n] - v) % q
    return np.array(out, np.int64)
