"""RNS-BFV homomorphic encryption, host side (numpy only).

The port of prefhetch_tpu/crypto/bfv.py for the encrypted re-rank with the
"full" and "q1" response wires: keygen / encrypt / decrypt on the client
side, the seeded symmetric query wire, and wire ↔ ciphertext conversion on
the server side. Ciphertexts are (c0, c1) pairs of RNS limb arrays [L, N]
int64; the server-side hot path (engine/hecompute.py) works in the NTT
domain, so one candidate block costs one pointwise modular multiply per
limb. The same integer seed gives the same keys and wires as the JAX
package (tests/test_torch_bfv.py).

Not ported yet (they come with the packed response wire): ct×ct ``mul`` with
relinearization, Galois keys and automorphisms, key switching, and the
threefry-seeded wire (``tf_uniform_rns``, ``seedTf``): ``ct_from_wire``
refuses a ``seedTf`` ciphertext.

Security note: parameters follow the standard HE security tables
(N=4096, log q ≈ 60 → >128-bit classical security); error σ=3.2 centered
binomial; ternary secrets.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from prefhetch_tpu_torch.crypto.ntt import NTTTables, build_tables, intt, ntt
from prefhetch_tpu_torch.crypto.params import BFVParams


def _b64_u32(x: np.ndarray) -> str:
    """Residues (< 2^30) as base64 little-endian uint32."""
    return base64.b64encode(
        np.ascontiguousarray(x.astype("<u4")).tobytes()
    ).decode()


def _u32_b64(s: str, shape) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(s), dtype="<u4"
    ).astype(np.int64).reshape(shape)


@dataclasses.dataclass
class SecretKey:
    s_rns: np.ndarray        # [L, N] int64 — s mod q_i


@dataclasses.dataclass
class PublicKey:
    b_rns: np.ndarray        # [L, N] — b = -(a·s + e) mod q_i
    a_rns: np.ndarray        # [L, N]


@dataclasses.dataclass
class Ciphertext:
    """BFV ciphertext (c0, c1); is_ntt marks NTT-domain representation."""

    c0: np.ndarray           # [L, N] int64
    c1: np.ndarray           # [L, N] int64
    is_ntt: bool = False

    def to_wire(self) -> dict:
        """JSON-serializable form for the HTTP protocol.

        Residues are < 2^30, so limbs travel as base64 little-endian uint32 —
        ~43KB per N=4096 2-limb ciphertext instead of ~1MB of JSON digits.
        """
        return {
            "c0": _b64_u32(self.c0),
            "c1": _b64_u32(self.c1),
            "shape": list(self.c0.shape),
            "isNtt": self.is_ntt,
        }

    @staticmethod
    def from_wire(obj: dict) -> "Ciphertext":
        shape = tuple(obj["shape"])
        return Ciphertext(
            c0=_u32_b64(obj["c0"], shape), c1=_u32_b64(obj["c1"], shape),
            is_ntt=bool(obj.get("isNtt", False)),
        )


def _sample_ternary(rng, shape) -> np.ndarray:
    return rng.integers(-1, 2, size=shape).astype(np.int64)


def _sample_sparse_ternary(rng, n: int, h: int) -> np.ndarray:
    """Ternary secret with EXACTLY h nonzero (±1) coefficients.

    The modulus-switched response wire (engine/hecompute.py *_q1) needs the
    mod-down rounding error (1+‖s‖₁)/2 under Δ'/2 = q1/(2t) ≈ 32 at the
    N=4096, t=2^24 operating point, so ‖s‖₁ = h must stay ≤ ~62; h=48 leaves
    a deterministic margin. Sparse ternary keys are the standard HE
    trade-off for rescaling headroom (HEAAN uses h=64); at N=4096 with
    q ≈ 2^60 the lattice-security margin over 128 bits absorbs it."""
    # partial Fisher-Yates over [0, n): needs only rng.integers, which both
    # numpy Generators and the OS-entropy SecureRNG provide
    pool = np.arange(n)
    for i in range(h):
        j = int(rng.integers(i, n))
        pool[i], pool[j] = pool[j], pool[i]
    s = np.zeros(n, np.int64)
    signs = np.where(rng.integers(0, 2, size=h) == 0, -1, 1)
    s[pool[:h]] = signs
    return s


def _binomial_half(rng, k: int, shape) -> np.ndarray:
    if hasattr(rng, "binomial_half"):           # SecureRNG (production)
        return rng.binomial_half(k, shape)
    return rng.binomial(k, 0.5, size=shape).astype(np.int64)


def _sample_error(rng, shape, sigma: float = 3.2) -> np.ndarray:
    """Centered binomial approximation of a discrete gaussian (σ≈3.2),
    vectorized over arbitrary shapes."""
    k = 21  # CB(21) has σ = sqrt(21/2) ≈ 3.24
    return _binomial_half(rng, k, shape) - _binomial_half(rng, k, shape)


class BFVContext:
    """Parameter-bound operations on the host — the client side and the
    correctness oracle; engine/hecompute.py holds the batched device path
    for the server's ct×pt MACs."""

    def __init__(self, params: BFVParams):
        self.params = params
        self.tables: List[NTTTables] = [
            build_tables(q, params.n) for q in params.qs
        ]
        self._delta = np.array(params.delta_rns(), np.int64)  # [L]

    # -- helpers --------------------------------------------------------
    def _to_rns(self, coeffs: Sequence[int]) -> np.ndarray:
        """Signed/big-int coefficient vector → [L, N] residues."""
        out = np.empty((len(self.params.qs), self.params.n), np.int64)
        arr = np.asarray(coeffs, dtype=object)
        for i, q in enumerate(self.params.qs):
            out[i] = np.array([int(c) % q for c in arr], np.int64)
        return out

    def _rns_small(self, small: np.ndarray) -> np.ndarray:
        """Small signed int64 vector → [L, N] residues (no big ints)."""
        qs = np.array(self.params.qs, np.int64)[:, None]
        return np.mod(small[None, :].astype(np.int64), qs)

    def _polymul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """[L, N] ⊙ [L, N] negacyclic product, per limb."""
        out = np.empty_like(a)
        for i, tb in enumerate(self.tables):
            out[i] = intt(ntt(a[i], tb) * ntt(b[i], tb) % tb.q, tb)
        return out

    def ntt_fwd(self, x: np.ndarray) -> np.ndarray:
        return np.stack([ntt(x[i], tb) for i, tb in enumerate(self.tables)])

    def ntt_fwd_batch(self, x: np.ndarray) -> np.ndarray:
        """[M, L, N] coeff-domain → NTT domain, one batched NTT per limb."""
        out = np.empty_like(x)
        for i, tb in enumerate(self.tables):
            out[:, i] = ntt(x[:, i], tb)
        return out

    def intt_batch(self, x: np.ndarray) -> np.ndarray:
        """[M, L, N] NTT domain → coeff domain, one batched INTT per limb."""
        out = np.empty_like(x)
        for i, tb in enumerate(self.tables):
            out[:, i] = intt(x[:, i], tb)
        return out

    def ntt_inv(self, x: np.ndarray) -> np.ndarray:
        return np.stack([intt(x[i], tb) for i, tb in enumerate(self.tables)])

    # -- keygen ---------------------------------------------------------
    def keygen(
        self, rng: np.random.Generator, sparse_h: Optional[int] = None
    ) -> Tuple[SecretKey, PublicKey]:
        p = self.params
        s = (_sample_sparse_ternary(rng, p.n, sparse_h)
             if sparse_h else _sample_ternary(rng, p.n))
        e = _sample_error(rng, p.n)
        # 'a' must be one ring element mod q = Π q_i: sample big-int coeffs
        a_int = [int(rng.integers(0, 1 << 62)) % p.q for _ in range(p.n)]
        a_rns = self._to_rns(a_int)
        s_rns = self._rns_small(s)
        e_rns = self._rns_small(e)
        qs = np.array(p.qs, np.int64)[:, None]
        b_rns = np.mod(-(self._polymul(a_rns, s_rns) + e_rns), qs)
        return SecretKey(s_rns=s_rns), PublicKey(b_rns=b_rns, a_rns=a_rns)

    # -- encrypt / decrypt ----------------------------------------------
    def encrypt(
        self, pk: PublicKey, m: np.ndarray, rng: np.random.Generator
    ) -> Ciphertext:
        """m: [N] ints in [0, t)."""
        p = self.params
        assert m.shape == (p.n,)
        u = self._rns_small(_sample_ternary(rng, p.n))
        e1 = self._rns_small(_sample_error(rng, p.n))
        e2 = self._rns_small(_sample_error(rng, p.n))
        qs = np.array(p.qs, np.int64)[:, None]
        dm = self._delta[:, None] * np.mod(
            m[None, :].astype(np.int64), p.t
        ) % qs
        c0 = np.mod(self._polymul(pk.b_rns, u) + e1 + dm, qs)
        c1 = np.mod(self._polymul(pk.a_rns, u) + e2, qs)
        return Ciphertext(c0=c0, c1=c1)

    # -- seeded symmetric encryption ------------------------------------
    def expand_a(self, seed: bytes) -> np.ndarray:
        """Deterministic uniform ring element mod q from a public seed:
        SHAKE-256 stream, 16 bytes/coefficient (mod-q bias < 2^-68).
        Client and server derive the identical `a`, so symmetric
        ciphertexts travel as (c0, 32-byte seed) — HALF the upload of a
        full (c0, c1) pair (the SEAL "seeded ciphertext" trick)."""
        p = self.params
        buf = hashlib.shake_256(seed).digest(16 * p.n)
        words = np.frombuffer(buf, dtype="<u8").reshape(p.n, 2)
        lo, hi = words[:, 0], words[:, 1]
        out = np.empty((len(p.qs), p.n), np.int64)
        for i, qi in enumerate(p.qs):
            t64 = (1 << 64) % qi
            # (hi·2^64 + lo) mod qi in uint64: products stay < 2^60
            out[i] = (((hi % qi) * t64 + lo % qi) % qi).astype(np.int64)
        return out

    def encrypt_symmetric_batch_ntt(
        self, sk: SecretKey, ms: np.ndarray, rng
    ) -> List[dict]:
        """Encrypt B plaintexts [B, N] under the SECRET key directly into
        NTT domain, returning seeded wire dicts {c0, seed, shape, isNtt}.

        c1 = a (uniform, derived from a fresh public seed), c0 = −a·s − e
        + Δm, so decrypt(c0 + c1·s) works unchanged. Noise is a single
        fresh error term — strictly below the public-key path's u·e noise.
        The query-upload wire shrinks ~2× (only c0 + 32 bytes travel)."""
        p = self.params
        B = ms.shape[0]
        qs = np.array(p.qs, np.int64)[:, None, None]
        e = _sample_error(rng, (B, p.n))
        e_rns = np.mod(e[None], qs)                           # [L, B, N]
        dm = self._delta[:, None, None] * np.mod(
            ms[None].astype(np.int64), p.t
        ) % qs
        seeds = [
            bytes(rng.integers(0, 256, size=32, dtype=np.uint8).tolist())
            for _ in range(B)
        ]
        a_rns = np.stack([self.expand_a(s) for s in seeds])   # [B, L, N]
        c0 = np.empty((B, len(p.qs), p.n), np.int64)
        for i, tb in enumerate(self.tables):
            qi = tb.q
            s_ntt = ntt(sk.s_rns[i], tb)
            a_ntt = ntt(a_rns[:, i], tb)                      # [B, N]
            body = np.mod(dm[i] - e_rns[i], qi)
            c0[:, i] = (qi - a_ntt * s_ntt % qi + ntt(body, tb)) % qi
        return [
            {
                "c0": _b64_u32(c0[b]),
                "seed": base64.b64encode(seeds[b]).decode(),
                "shape": [len(p.qs), p.n],
                "isNtt": True,
            }
            for b in range(B)
        ]

    def ct_from_wire(self, obj: dict) -> Ciphertext:
        """Wire → Ciphertext, expanding the seeded symmetric form (the c1
        component is regenerated from the public seed; NTT'd when the wire
        is NTT-domain)."""
        if "seedTf" in obj:
            raise NotImplementedError(
                "threefry-seeded ciphertexts (seedTf) belong to the packed "
                "response wire, which is not ported yet"
            )
        if "seed" not in obj:
            return Ciphertext.from_wire(obj)
        c0 = _u32_b64(obj["c0"], tuple(obj["shape"]))
        a_rns = self.expand_a(base64.b64decode(obj["seed"]))
        is_ntt = bool(obj.get("isNtt", False))
        c1 = self.ntt_fwd(a_rns) if is_ntt else a_rns
        return Ciphertext(c0=c0, c1=c1, is_ntt=is_ntt)

    def _crt_fraction(self, v: np.ndarray, i: int) -> np.ndarray:
        """Limb i's term of v/q mod 1: (v_i·[q̂_i⁻¹]_{q_i} mod q_i)/q_i."""
        qi = self.params.qs[i]
        inv = pow((self.params.q // qi) % qi, -1, qi)
        return ((v * inv) % qi).astype(np.float64) / qi   # product < 2^60

    def decrypt(self, sk: SecretKey, ct: Ciphertext) -> np.ndarray:
        """Returns plaintext [N] ints in [0, t).

        Rounding m = round(t·v/q) is done via the CRT fraction identity
        v/q ≡ Σ_i (v_i·[q̂_i⁻¹]_{q_i} mod q_i)/q_i (mod 1) — fully
        vectorized float64, no big-int loop. float64 carries 53 bits ≫
        log2(t)+margin, so the rounding is exact whenever the noise is not
        within ~2^-28·q of a boundary (far beyond decryption failure)."""
        ct = self.from_ntt(ct) if ct.is_ntt else ct
        p = self.params
        qs = np.array(p.qs, np.int64)[:, None]
        v = np.mod(ct.c0 + self._polymul(ct.c1, sk.s_rns), qs)  # [L, N]
        frac = np.zeros(p.n, np.float64)
        for i in range(len(p.qs)):
            frac += self._crt_fraction(v[i], i)
        frac -= np.floor(frac)               # mod 1
        return np.round(p.t * frac).astype(np.int64) % p.t

    def decrypt_batch(self, sk: SecretKey, cts: List["Ciphertext"]) -> np.ndarray:
        """Decrypt B ciphertexts at once → [B, N] ints in [0, t): the
        inverse NTTs are batched across ciphertexts and NTT(s) is computed
        once per limb."""
        p = self.params
        B = len(cts)
        is_ntt = cts[0].is_ntt
        c0 = np.stack([c.c0 for c in cts])        # [B, L, N]
        c1 = np.stack([c.c1 for c in cts])
        frac = np.zeros((B, p.n), np.float64)
        for i, tb in enumerate(self.tables):
            qi = tb.q
            c0i = c0[:, i] if is_ntt else ntt(c0[:, i], tb)
            c1i = c1[:, i] if is_ntt else ntt(c1[:, i], tb)
            s_ntt = ntt(sk.s_rns[i], tb)          # [N]
            v = intt((c0i + c1i * s_ntt % qi) % qi, tb)  # [B, N]
            frac += self._crt_fraction(v, i)
        frac -= np.floor(frac)
        return np.round(p.t * frac).astype(np.int64) % p.t

    def _crt_compose(self, v: np.ndarray) -> List[int]:
        """[L, N] residues → list of N big ints in [0, q)."""
        p = self.params
        q = p.q
        comps = []
        for qi in p.qs:
            qhat = q // qi
            comps.append((qhat, pow(qhat % qi, -1, qi), qi))
        out = []
        for j in range(p.n):
            acc = 0
            for i, (qhat, inv, qi) in enumerate(comps):
                acc += qhat * ((int(v[i, j]) * inv) % qi)
            out.append(acc % q)
        return out

    # -- domain changes ---------------------------------------------------
    def to_ntt(self, ct: Ciphertext) -> Ciphertext:
        assert not ct.is_ntt
        return Ciphertext(
            c0=self.ntt_fwd(ct.c0), c1=self.ntt_fwd(ct.c1), is_ntt=True
        )

    def from_ntt(self, ct: Ciphertext) -> Ciphertext:
        assert ct.is_ntt
        return Ciphertext(
            c0=self.ntt_inv(ct.c0), c1=self.ntt_inv(ct.c1), is_ntt=False
        )
