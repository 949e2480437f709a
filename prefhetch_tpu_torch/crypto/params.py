"""RLWE parameter sets with NTT-friendly RNS primes.

Copy of prefhetch_tpu/crypto/params.py (pure Python; the primes and roots are
the same integers). BASELINE.json's configs fix the operating points:
BFV poly degree N=4096 with 2 RNS limbs for encrypted L2 re-rank; CKKS
N=8192 with slot packing. Primes are ~30-bit and ≡ 1 (mod 2N) so the
negacyclic NTT exists and per-limb arithmetic fits comfortably in int64
lanes (products < 2^60).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Tuple


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(n_poly: int, bits: int, count: int) -> List[int]:
    """Find `count` primes q ≡ 1 (mod 2·n_poly) just below 2^bits,
    descending — the standard RNS prime chain construction."""
    m = 2 * n_poly
    q = (1 << bits) - ((1 << bits) - 1) % m - 1 + 1  # largest ≡1 mod m below 2^bits
    q = ((1 << bits) // m) * m + 1
    if q >= (1 << bits):
        q -= m
    out = []
    while len(out) < count:
        if _is_prime(q):
            out.append(q)
        q -= m
        if q < (1 << (bits - 1)):
            raise RuntimeError("ran out of primes")
    return out


def _primitive_root(q: int) -> int:
    """Smallest generator of Z_q^* (q prime)."""
    phi = q - 1
    factors = []
    x = phi
    d = 2
    while d * d <= x:
        if x % d == 0:
            factors.append(d)
            while x % d == 0:
                x //= d
        d += 1
    if x > 1:
        factors.append(x)
    g = 2
    while True:
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
        g += 1


def root_of_unity(q: int, order: int) -> int:
    """Primitive `order`-th root of unity mod q (order | q-1)."""
    assert (q - 1) % order == 0
    g = _primitive_root(q)
    psi = pow(g, (q - 1) // order, q)
    assert pow(psi, order, q) == 1 and pow(psi, order // 2, q) == q - 1
    return psi


@dataclasses.dataclass(frozen=True)
class BFVParams:
    """RNS-BFV parameters.

    n: polynomial degree (power of 2); t: plaintext modulus;
    qs: RNS prime chain (ciphertext modulus q = Π qs).
    """

    n: int
    t: int
    qs: Tuple[int, ...]

    @property
    def q(self) -> int:
        out = 1
        for qi in self.qs:
            out *= qi
        return out

    @property
    def delta(self) -> int:
        """Scaling factor floor(q/t) used to embed plaintexts."""
        return self.q // self.t

    def delta_rns(self) -> List[int]:
        return [self.delta % qi for qi in self.qs]

    @property
    def slots_per_block(self) -> int:
        return self.n


@lru_cache(maxsize=None)
def default_bfv_params(n: int = 4096, t_bits: int = 24, n_limbs: int = 2) -> BFVParams:
    """BASELINE.json config 2 operating point: N=4096, 2 RNS limbs.

    t = 2^24 comfortably holds SIFT inner products (≤ 128·255² < 2^23).
    """
    qs = tuple(find_ntt_primes(n, 30, n_limbs))
    return BFVParams(n=n, t=1 << t_bits, qs=qs)


@lru_cache(maxsize=None)
def bfv_params_for(
    n: int, t_bits: int, n_limbs: int, odd_t: bool = False
) -> BFVParams:
    """BFVParams from the runtime HEParams config knobs.

    odd_t=True bumps the plaintext modulus to 2^t_bits + 1: the packed
    single-ct response (resp_mod="packed") needs the coefficient-extraction
    factor 2^log2(d) invertible mod t, which a power-of-two t is not."""
    return BFVParams(
        n=n, t=(1 << t_bits) + (1 if odd_t else 0),
        qs=tuple(find_ntt_primes(n, 30, n_limbs)),
    )


@lru_cache(maxsize=None)
def pir_params_for(n: int, t: int, n_limbs: int) -> BFVParams:
    """BFV parameters for the PIR subsystem (explicit plaintext modulus)."""
    return BFVParams(n=n, t=t, qs=tuple(find_ntt_primes(n, 30, n_limbs)))


@dataclasses.dataclass(frozen=True)
class CKKSParams:
    """RNS-CKKS parameters: N=8192, scale 2^scale_bits, prime chain qs."""

    n: int
    scale_bits: int
    qs: Tuple[int, ...]

    @property
    def slots(self) -> int:
        return self.n // 2


@lru_cache(maxsize=None)
def default_ckks_params(n: int = 8192, n_limbs: int = 3) -> CKKSParams:
    """BASELINE.json config 3 operating point: CKKS N=8192, slot packing."""
    qs = tuple(find_ntt_primes(n, 30, n_limbs))
    return CKKSParams(n=n, scale_bits=26, qs=qs)


@lru_cache(maxsize=None)
def ckks_params_for(n: int, scale_bits: int, n_limbs: int) -> CKKSParams:
    """CKKSParams from the runtime HEParams config knobs."""
    return CKKSParams(
        n=n, scale_bits=scale_bits, qs=tuple(find_ntt_primes(n, 30, n_limbs))
    )
