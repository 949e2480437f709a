"""RNS-BFV homomorphic encryption, host side (numpy only).

The port of prefhetch_tpu/crypto/bfv.py for the encrypted re-rank with the
"full", "q1" and "packed" response wires: keygen / encrypt / decrypt on the
client side, the seeded symmetric query wires (SHAKE ``seed`` and threefry
``seedTf``), wire ↔ ciphertext conversion on the server side, and for the
packed wire the Galois keys, automorphisms and special-modulus key
switching (the host oracle of engine/hecompute.py's device program).
Ciphertexts are (c0, c1) pairs of RNS limb arrays [L, N] int64; the
server-side hot path (engine/hecompute.py) works in the NTT domain, so one
candidate block costs one pointwise modular multiply per limb. The same
integer seed gives the same keys and wires as the JAX package
(tests/test_torch_bfv.py, tests/test_torch_threefry.py).

For PIR (crypto/pir.py): batched public-key encryption
(``encrypt_batch``, ``encrypt_batch_ntt``), ``add``, ``plain_to_ntt``,
``mul_plain_ntt`` and ``noise_budget_bits``. Also the ct×ct ``mul`` with
relinearization (``relin_keygen``) and the exact mixed-radix (Garner)
helpers it needs, so every function of the JAX module has its copy here.
The CKKS scheme is crypto/ckks.py.

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
from prefhetch_tpu_torch.crypto.params import BFVParams, find_ntt_primes


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
class RelinKey:
    """Key-switching key (Galois, later relinearization), special-modulus
    form.

    digit_bits sets the decomposition width the key was generated for:
    15 (n_digits=2/limb — the conservative default, key-switch noise
    ~2^15/p below the digit) or 30 (one digit per limb — HALF the digit
    NTT rows in every switch; noise ~2^15 larger, still orders under the
    packed wire's Δ/2 = q/2t budget — the packed-response tests decrypt
    exact distances at N=4096)."""

    special_p: int
    b: np.ndarray            # [n_comp, L+1, N]
    a: np.ndarray            # [n_comp, L+1, N]
    ext: tuple               # basis qs + (special_p,)
    digit_bits: int = 15

    def to_wire(self) -> dict:
        return {
            "specialP": self.special_p,
            "ext": list(self.ext),
            "shape": list(self.b.shape),
            "b": _b64_u32(self.b),
            "a": _b64_u32(self.a),
            "digitBits": self.digit_bits,
        }

    @staticmethod
    def from_wire(obj: dict) -> "RelinKey":
        shape = tuple(obj["shape"])
        return RelinKey(
            special_p=int(obj["specialP"]),
            b=_u32_b64(obj["b"], shape), a=_u32_b64(obj["a"], shape),
            ext=tuple(obj["ext"]),
            digit_bits=int(obj.get("digitBits", 15)),
        )


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


_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32_20(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011) on numpy uint32
    arrays, wrapping. Written out (not a library PRF) so the counter layout
    is the frozen wire contract the JAX package and the device form
    (ops/threefry.py) share."""
    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for g in range(5):
        for r in _TF_ROT[g % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def tf_uniform_rns(key_data, qs, n: int) -> np.ndarray:
    """[L, N] uniform residues mod each q from a threefry2x32 key, numpy.

    Counter layout (frozen wire contract): 2·L·N lanes of
    Threefry-2x32-20 with counters iota(2·L·N) split in half; draw i of
    limb l takes hi = out0[l·N + i] (top 30 bits) and lo = out1[l·N + i],
    folded from 62 bits mod q by the shift reduction (bias < 2^-32 — far
    below anything that matters for the PUBLIC RLWE mask). The server's
    device form is ops/threefry.py. key_data: [2] uint32 (the ct wire's
    "seedTf" field)."""
    L = len(qs)
    total = L * n
    kd = np.asarray(key_data, np.uint32)
    cnt = np.arange(2 * total, dtype=np.uint32)
    o0, o1 = _threefry2x32_20(kd[0], kd[1], cnt[:total], cnt[total:])
    hi = (o0 >> np.uint32(2)).astype(np.int64)
    lo = o1.astype(np.int64)
    v = ((hi << 32) | lo).reshape(L, n)            # uniform < 2^62
    out = np.empty((L, n), np.int64)
    for i, q in enumerate(qs):
        q = int(q)
        delta = (1 << 30) - q
        x = v[i]
        b = 62
        m30 = (1 << 30) - 1
        dbits = max(1, (delta - 1).bit_length())
        while b > 31:
            x = (x & m30) + (x >> 30) * delta
            b = max(b - 30 + dbits + 1, 31)
        x = np.where(x >= q, x - q, x)
        out[i] = np.where(x >= q, x - q, x)
    return out


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

    def encrypt_batch(
        self, pk: PublicKey, ms: np.ndarray, rng: np.random.Generator
    ) -> List[Ciphertext]:
        """Encrypt B plaintexts [B, N] at once (batched NTTs)."""
        p = self.params
        B = ms.shape[0]
        qs = np.array(p.qs, np.int64)[:, None, None]          # [L,1,1]
        u = _sample_ternary(rng, (B, p.n))
        e1 = _sample_error(rng, (B, p.n))
        e2 = _sample_error(rng, (B, p.n))
        u_rns = np.mod(u[None], qs)                           # [L, B, N]
        e1_rns = np.mod(e1[None], qs)
        e2_rns = np.mod(e2[None], qs)
        dm = self._delta[:, None, None] * np.mod(
            ms[None].astype(np.int64), p.t
        ) % qs
        c0 = np.empty((B, len(p.qs), p.n), np.int64)
        c1 = np.empty_like(c0)
        for i, tb in enumerate(self.tables):
            qi = tb.q
            b_ntt = ntt(pk.b_rns[i], tb)
            a_ntt = ntt(pk.a_rns[i], tb)
            u_ntt = ntt(u_rns[i], tb)                         # [B, N]
            c0[:, i] = (intt(b_ntt[None] * u_ntt % qi, tb) + e1_rns[i]
                        + dm[i]) % qi
            c1[:, i] = (intt(a_ntt[None] * u_ntt % qi, tb) + e2_rns[i]) % qi
        return [Ciphertext(c0=c0[b], c1=c1[b]) for b in range(B)]

    def encrypt_batch_ntt(
        self, pk: PublicKey, ms: np.ndarray, rng
    ) -> List[Ciphertext]:
        """Encrypt B plaintexts [B, N] directly into NTT domain: the
        masking products b·u, a·u are formed in NTT domain and the
        noise/message terms are forward-NTT'd once — 3 batched NTTs per
        limb instead of the 5 of encrypt_batch + to_ntt."""
        p = self.params
        B = ms.shape[0]
        qs = np.array(p.qs, np.int64)[:, None, None]          # [L,1,1]
        u = _sample_ternary(rng, (B, p.n))
        e1 = _sample_error(rng, (B, p.n))
        e2 = _sample_error(rng, (B, p.n))
        u_rns = np.mod(u[None], qs)                           # [L, B, N]
        e1_rns = np.mod(e1[None], qs)
        e2_rns = np.mod(e2[None], qs)
        dm = self._delta[:, None, None] * np.mod(
            ms[None].astype(np.int64), p.t
        ) % qs
        c0 = np.empty((B, len(p.qs), p.n), np.int64)
        c1 = np.empty_like(c0)
        for i, tb in enumerate(self.tables):
            qi = tb.q
            b_ntt = ntt(pk.b_rns[i], tb)
            a_ntt = ntt(pk.a_rns[i], tb)
            u_ntt = ntt(u_rns[i], tb)                         # [B, N]
            c0[:, i] = (
                b_ntt[None] * u_ntt % qi
                + ntt((e1_rns[i] + dm[i]) % qi, tb)
            ) % qi
            c1[:, i] = (a_ntt[None] * u_ntt % qi + ntt(e2_rns[i], tb)) % qi
        return [
            Ciphertext(c0=c0[b], c1=c1[b], is_ntt=True) for b in range(B)
        ]

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

    def encrypt_symmetric_batch_ntt_tf(
        self, sk: SecretKey, ms: np.ndarray, rng
    ) -> List[dict]:
        """Seeded symmetric encryption with DEVICE-expandable seeds.

        Same construction as encrypt_symmetric_batch_ntt, but the public
        mask a is drawn with the threefry2x32 counter PRF (tf_uniform_rns)
        instead of the SHAKE stream: the server regenerates a inside its
        device program from the 8-byte key (ops/threefry.py), so the c1
        half of the query upload (host expansion, wire and h2d) disappears.

        Security note: this trades the mask PRG from SHAKE-256 to
        Threefry-2x32-20 (a counter PRF without a cryptographic security
        proof — strong statistically, used here only to derive the PUBLIC
        uniform RLWE mask). Deployments wanting a standard-assumption PRG
        keep the SHAKE wire (encrypt_symmetric_batch_ntt)."""
        p = self.params
        B = ms.shape[0]
        qs = np.array(p.qs, np.int64)[:, None, None]
        e = _sample_error(rng, (B, p.n))
        e_rns = np.mod(e[None], qs)                           # [L, B, N]
        dm = self._delta[:, None, None] * np.mod(
            ms[None].astype(np.int64), p.t
        ) % qs
        keys = rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint32)
        a_rns = np.stack(
            [tf_uniform_rns(keys[b], p.qs, p.n) for b in range(B)]
        )                                                     # [B, L, N]
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
                "seedTf": [int(keys[b, 0]), int(keys[b, 1])],
                "shape": [len(p.qs), p.n],
                "isNtt": True,
            }
            for b in range(B)
        ]

    def ct_from_wire(self, obj: dict) -> Ciphertext:
        """Wire → Ciphertext, expanding the seeded symmetric forms (the c1
        component is regenerated from the public SHAKE seed or threefry
        key; NTT'd when the wire is NTT-domain)."""
        if "seed" not in obj and "seedTf" not in obj:
            return Ciphertext.from_wire(obj)
        c0 = _u32_b64(obj["c0"], tuple(obj["shape"]))
        if "seedTf" in obj:
            a_rns = tf_uniform_rns(np.asarray(obj["seedTf"], np.uint32),
                                   self.params.qs, self.params.n)
        else:
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

    def noise_budget_bits(self, sk: SecretKey, ct: Ciphertext,
                          m: np.ndarray) -> int:
        """Remaining noise budget log2(q/(2t)) − log2(noise∞)."""
        ct = self.from_ntt(ct) if ct.is_ntt else ct
        p = self.params
        qs = np.array(p.qs, np.int64)[:, None]
        v = np.mod(ct.c0 + self._polymul(ct.c1, sk.s_rns), qs)
        big = self._crt_compose(v)
        q, t = p.q, p.t
        delta = p.delta
        worst = 0
        for j, x in enumerate(big):
            noise = (x - delta * int(m[j])) % q
            noise = min(noise, q - noise)
            worst = max(worst, noise)
        return (q // (2 * t)).bit_length() - max(worst, 1).bit_length()

    # -- generic special-modulus key switching ----------------------------
    @property
    def _ext_basis(self):
        """qs plus the auxiliary primes that cover N·q² (the exact basis of
        ct×ct tensoring); the special prime is drawn from outside it."""
        if not hasattr(self, "_ext_cached"):
            L = len(self.params.qs)
            need_bits = (
                self.params.q.bit_length() * 2
                + self.params.n.bit_length() + 2
            )
            n_extra = -(-max(0, need_bits - 30 * L) // 29)
            allp = find_ntt_primes(self.params.n, 30, L + n_extra + 1)
            aux = tuple(pp for pp in allp if pp not in self.params.qs)[
                : n_extra + 1
            ]
            self._ext_cached = tuple(self.params.qs) + aux
            self._ext_tables = [
                build_tables(q, self.params.n) for q in self._ext_cached
            ]
        return self._ext_cached

    # -- exact mixed-radix (Garner) RNS arithmetic -----------------------
    # The ct×ct tensoring needs base extension and the round(t·v/q) scale.
    # Both are exact and vectorized here: values convert to mixed-radix
    # digits (x = d₀ + p₀·d₁ + p₀p₁·d₂ + …, every intermediate < 2^60 in
    # int64) and reduce per target prime by Horner — no big-int loops.

    @staticmethod
    def _garner_digits(x_rns: np.ndarray, primes) -> np.ndarray:
        """[L, …] residues → mixed-radix digits [L, …] (exact, int64)."""
        digits = []
        for i, pi in enumerate(primes):
            t = np.mod(x_rns[i], pi)
            for j in range(i):
                inv = pow(primes[j] % pi, -1, pi)
                t = np.mod(t - digits[j], pi) * inv % pi
            digits.append(t)
        return np.stack(digits)

    @staticmethod
    def _digits_mod(digits: np.ndarray, primes, m: int) -> np.ndarray:
        """Mixed-radix digits → value mod m (Horner; products < 2^60)."""
        L = len(primes)
        acc = np.mod(digits[L - 1], m)
        for i in range(L - 2, -1, -1):
            acc = (acc * (primes[i] % m) + digits[i]) % m
        return acc

    @staticmethod
    def _digits_gt(digits: np.ndarray, primes, threshold: int) -> np.ndarray:
        """Elementwise (value > threshold) from mixed-radix digits."""
        tdig = []
        t = threshold
        for p_ in primes:
            tdig.append(t % p_)
            t //= p_
        gt = np.zeros(digits.shape[1:], bool)
        eq = np.ones(digits.shape[1:], bool)
        for i in range(len(primes) - 1, -1, -1):
            gt |= eq & (digits[i] > tdig[i])
            eq &= digits[i] == tdig[i]
        return gt

    def _lift_to_basis(self, x_rns: np.ndarray) -> np.ndarray:
        """[L, N] residues mod qs → [B, N] residues over the full ext basis
        (exact vectorized base extension via mixed-radix digits)."""
        basis = self._ext_basis
        qs = self.params.qs
        L = len(qs)
        x = np.mod(x_rns, np.array(qs, np.int64)[:, None])
        dig = self._garner_digits(x, qs)
        out = np.empty((len(basis), self.params.n), np.int64)
        out[:L] = x
        for i in range(L, len(basis)):
            out[i] = self._digits_mod(dig, qs, basis[i])
        return out

    def mul(self, x: Ciphertext, y: Ciphertext, rk: RelinKey) -> Ciphertext:
        """Homomorphic ct×ct with relinearization.

        The tensor products are computed over the integers (coefficients up
        to N·q²) in the extended RNS basis, then scaled by t/q exactly. With
        v' ∈ [0, Q), v̂ = v' − Q·F (F = [v' > Q/2]) and v' = w'·q + u':
        r = t·w' + round(t·u'/q) − t·A·F, A = Q/q. w' = (v' − u')/q is
        exact in the aux basis; round(t·u'/q) ∈ [0, t] comes from the
        float64 CRT fraction (error ≤ 1, absorbed by the ct×ct noise)."""
        x = self.from_ntt(x) if x.is_ntt else x
        y = self.from_ntt(y) if y.is_ntt else y
        basis = self._ext_basis
        tables = self._ext_tables
        p = self.params

        def polymul_basis(a, b):
            out = np.empty((len(basis), p.n), np.int64)
            for i, tb in enumerate(tables):
                out[i] = intt(ntt(a[i], tb) * ntt(b[i], tb) % tb.q, tb)
            return out

        x0 = self._lift_to_basis(x.c0)
        x1 = self._lift_to_basis(x.c1)
        y0 = self._lift_to_basis(y.c0)
        y1 = self._lift_to_basis(y.c1)
        qb = np.array(basis, np.int64)[:, None]
        d0 = polymul_basis(x0, y0)
        d1 = np.mod(polymul_basis(x0, y1) + polymul_basis(x1, y0), qb)
        d2 = polymul_basis(x1, y1)

        Q = 1
        for q in basis:
            Q *= q
        L = len(p.qs)
        aux = basis[L:]
        A = Q // p.q
        inv_q_aux = [pow(p.q % aj, -1, aj) for aj in aux]
        frac_inv = [pow((p.q // qi) % qi, -1, qi) for qi in p.qs]

        def round_scale(d):
            u_dig = self._garner_digits(d[:L], p.qs)      # u' = v' mod q
            v_dig = self._garner_digits(d, basis)
            F = self._digits_gt(v_dig, basis, Q // 2).astype(np.int64)
            frac = np.zeros(p.n, np.float64)
            for i, qi in enumerate(p.qs):
                frac += (d[i] * frac_inv[i] % qi).astype(np.float64) / qi
            frac -= np.floor(frac)
            rnd = np.round(p.t * frac).astype(np.int64)      # [0, t]
            w_aux = np.empty((len(aux), p.n), np.int64)
            for j, aj in enumerate(aux):
                uj = self._digits_mod(u_dig, p.qs, aj)
                w_aux[j] = np.mod(d[L + j] - uj, aj) * inv_q_aux[j] % aj
            w_dig = self._garner_digits(w_aux, aux)
            out = np.empty((L, p.n), np.int64)
            for i, qi in enumerate(p.qs):
                wi = self._digits_mod(w_dig, aux, qi)
                out[i] = np.mod(
                    (p.t % qi) * wi + rnd - (p.t % qi) * (A % qi) % qi * F,
                    qi,
                )
            return out

        c0 = round_scale(d0)
        c1 = round_scale(d1)
        c2 = round_scale(d2)
        ks0, ks1 = self._key_switch(c2, rk)
        qs = np.array(p.qs, np.int64)[:, None]
        return Ciphertext(c0=np.mod(c0 + ks0, qs), c1=np.mod(c1 + ks1, qs))

    @property
    def _special_p(self) -> int:
        if not hasattr(self, "_sp_cached"):
            p = self.params
            self._sp_cached = [
                q for q in find_ntt_primes(p.n, 30, len(self._ext_basis) + 2)
                if q not in self._ext_basis
            ][0]
        return self._sp_cached

    def _s_signed(self, sk: SecretKey) -> np.ndarray:
        """Recover the small signed secret from its first-limb residues."""
        q0 = self.params.qs[0]
        return np.where(
            sk.s_rns[0] > q0 // 2, sk.s_rns[0] - q0, sk.s_rns[0]
        )

    def _make_switch_key(
        self, sk: SecretKey, target_small: np.ndarray, rng,
        digit_bits: int = 15,
    ) -> RelinKey:
        """Key-switching key encrypting P·W_d·target under s over qs+[p]
        (digit_bits-wide decomposition — see RelinKey). `target_small` is
        a small signed polynomial (s(X^g), …)."""
        if 30 % digit_bits:
            raise ValueError(
                "digit_bits must divide the 30-bit limb width — consumers "
                "derive the ladder from the key shape (n_digits = 30/bits)")
        p = self.params
        sp = self._special_p
        ext = tuple(p.qs) + (sp,)
        ext_tables = [build_tables(q, p.n) for q in ext]
        qs_ext = np.array(ext, np.int64)[:, None]

        def polymul_ext(a, b):
            out = np.empty((len(ext), p.n), np.int64)
            for i, tb in enumerate(ext_tables):
                out[i] = intt(ntt(a[i], tb) * ntt(b[i], tb) % tb.q, tb)
            return out

        def to_ext_rns(small):
            return np.mod(small[None, :].astype(np.int64), qs_ext)

        s_ext = to_ext_rns(self._s_signed(sk))
        target_ext = to_ext_rns(np.asarray(target_small, np.int64))

        n_digits = -(-30 // digit_bits)
        big_q = p.q
        comps_b, comps_a = [], []
        for i, qi in enumerate(p.qs):
            qhat = big_q // qi
            Pi = qhat * pow(qhat % qi, -1, qi) % big_q
            for d in range(n_digits):
                W = 1 << (d * digit_bits)
                factor = Pi * W * sp % (big_q * sp)
                fac = np.array([factor % q for q in ext], np.int64)[:, None]
                # one ring element mod q·p: draws < 2^62 fit int64, so the
                # residues are exact
                a_rns = np.mod(rng.integers(0, 1 << 62, size=p.n)[None],
                               qs_ext)
                e_rns = to_ext_rns(_sample_error(rng, p.n))
                b_rns = np.mod(
                    -(polymul_ext(a_rns, s_ext) + e_rns)
                    + fac * target_ext % qs_ext,
                    qs_ext,
                )
                comps_b.append(b_rns)
                comps_a.append(a_rns)
        return RelinKey(
            special_p=sp, b=np.stack(comps_b), a=np.stack(comps_a),
            ext=ext, digit_bits=digit_bits,
        )

    def relin_keygen(self, sk: SecretKey, rng) -> RelinKey:
        """Evaluation key for s² (special-modulus, 15-bit digit decomposed)."""
        p = self.params
        sp = self._special_p
        ext = tuple(p.qs) + (sp,)
        ext_tables = [build_tables(q, p.n) for q in ext]
        qs_ext = np.array(ext, np.int64)[:, None]
        s_ext = np.mod(self._s_signed(sk)[None, :].astype(np.int64), qs_ext)
        s2_ext = np.empty((len(ext), p.n), np.int64)
        for i, tb in enumerate(ext_tables):
            s2_ext[i] = intt(ntt(s_ext[i], tb) ** 2 % tb.q, tb)
        # s² has coefficients up to ~N (small): its signed form mod sp
        s2_signed = np.where(
            s2_ext[-1] > sp // 2, s2_ext[-1] - sp, s2_ext[-1]
        )
        return self._make_switch_key(sk, s2_signed, rng)

    # -- Galois automorphisms (X → X^g) -------------------------------------
    @staticmethod
    def extraction_elts(n: int, d: int) -> List[int]:
        """Galois elements g_r = N/2^(r-1) + 1, r = 1..log2(d): after
        ct += σ_{g_r}(ct) for each r, every plaintext coefficient whose
        index is not ≡ 0 mod d is zeroed and the survivors are scaled by
        2^log2(d) (invert mod ODD t on the consumer side). The standard
        SealPIR oblivious-expansion automorphisms, run in the killing
        direction — the basis of the packed single-ct response."""
        rounds = (d - 1).bit_length()
        if 1 << rounds != d:
            raise ValueError("extraction needs a power-of-two stride d")
        return [n // (1 << r) + 1 for r in range(rounds)]

    def _automorphism_map(self, g: int):
        """Permutation/sign arrays: out[(k·g) mod N] = ± in[k]."""
        if not hasattr(self, "_auto_cache"):
            self._auto_cache = {}
        if g in self._auto_cache:
            return self._auto_cache[g]
        n = self.params.n
        k = np.arange(n)
        kg = (k * g) % (2 * n)
        dest = kg % n
        perm = np.empty(n, np.int64)
        sgn = np.empty(n, np.int64)
        perm[dest] = k
        sgn[dest] = np.where(kg < n, 1, -1)
        self._auto_cache[g] = (perm, sgn)
        return perm, sgn

    def _apply_auto_poly(self, poly: np.ndarray, g: int) -> np.ndarray:
        perm, sgn = self._automorphism_map(g)
        qs = np.array(self.params.qs, np.int64)[:, None]
        return np.mod(poly[:, perm] * sgn[None, :], qs)

    def galois_keygen(
        self, sk: SecretKey, elts, rng, digit_bits: int = 15
    ) -> dict:
        """Key-switching keys for Galois elements g (odd, mod 2N)."""
        out = {}
        s_signed = self._s_signed(sk)
        n = self.params.n
        for g in elts:
            k = np.arange(n)
            kg = (k * g) % (2 * n)
            s_rot = np.zeros(n, np.int64)
            s_rot[kg % n] = s_signed * np.where(kg < n, 1, -1)
            out[int(g)] = self._make_switch_key(
                sk, s_rot, rng, digit_bits=digit_bits
            )
        return out

    def apply_galois(self, ct: Ciphertext, g: int, gk: RelinKey) -> Ciphertext:
        """Substitution X → X^g on a ciphertext (plus key switch back to s)."""
        ct = self.from_ntt(ct) if ct.is_ntt else ct
        c0g = self._apply_auto_poly(ct.c0, g)
        c1g = self._apply_auto_poly(ct.c1, g)
        ks0, ks1 = self._key_switch(c1g, gk)
        qs = np.array(self.params.qs, np.int64)[:, None]
        return Ciphertext(c0=np.mod(c0g + ks0, qs), c1=ks1)

    def mul_monomial(self, ct: Ciphertext, e: int) -> Ciphertext:
        """ct × X^e (e may be negative) — a signed negacyclic coefficient
        rotation of both components; no keys needed."""
        ct = self.from_ntt(ct) if ct.is_ntt else ct
        n = self.params.n
        e = e % (2 * n)
        qs = np.array(self.params.qs, np.int64)[:, None]
        dest = (np.arange(n) + e) % (2 * n)
        sign = np.where(dest < n, 1, -1)

        def rot(poly):
            out = np.zeros_like(poly)
            out[:, dest % n] = poly * sign[None, :]
            return np.mod(out, qs)

        return Ciphertext(c0=rot(ct.c0), c1=rot(ct.c1))

    def _key_switch(self, poly: np.ndarray, rk: RelinKey):
        """Σ digits(poly) · rk over qs+[p], then exact division by p:
        ``_key_switch_batch`` of one polynomial."""
        out0, out1 = self._key_switch_batch(poly[None], rk)
        return out0[0], out1[0]

    def _key_switch_batch(self, polys: np.ndarray, rk: RelinKey):
        """[M, L, N] coefficient-domain polys → (ks0, ks1) [M, L, N].

        One forward-NTT batch over all (poly, digit) rows and one inverse
        per ext prime; each product is reduced mod q before the sum
        (n_comp products of ~2^60 would overflow int64 for 3+ limbs if
        summed raw); the special prime's residue is centred before the
        exact division by p."""
        p = self.params
        ext = rk.ext
        ext_tables = [build_tables(q, p.n) for q in ext]
        digit_bits = rk.digit_bits
        n_digits = -(-30 // digit_bits)
        mask = (1 << digit_bits) - 1
        M = polys.shape[0]
        L = len(p.qs)
        n_comp = L * n_digits
        digits = np.empty((M, n_comp, p.n), np.int64)
        for i in range(L):
            limb = polys[:, i]
            for d in range(n_digits):
                digits[:, i * n_digits + d] = (limb >> (d * digit_bits)) & mask
        acc0 = np.empty((M, len(ext), p.n), np.int64)
        acc1 = np.empty((M, len(ext), p.n), np.int64)
        flat = digits.reshape(M * n_comp, p.n)
        for e, q in enumerate(ext):
            tb = ext_tables[e]
            D = ntt(flat % q, tb).reshape(M, n_comp, p.n)
            Kb = ntt(rk.b[:, e] % q, tb)                 # [n_comp, N]
            Ka = ntt(rk.a[:, e] % q, tb)
            acc0[:, e] = intt((D * Kb[None] % q).sum(axis=1) % q, tb)
            acc1[:, e] = intt((D * Ka[None] % q).sum(axis=1) % q, tb)
        sp = rk.special_p
        half = sp // 2
        cp0 = np.where(acc0[:, -1] > half, acc0[:, -1] - sp, acc0[:, -1])
        cp1 = np.where(acc1[:, -1] > half, acc1[:, -1] - sp, acc1[:, -1])
        out0 = np.empty((M, L, p.n), np.int64)
        out1 = np.empty_like(out0)
        for i, qi in enumerate(p.qs):
            inv_p = pow(sp, -1, qi)
            out0[:, i] = (acc0[:, i] - cp0) % qi * inv_p % qi
            out1[:, i] = (acc1[:, i] - cp1) % qi * inv_p % qi
        return out0, out1

    def apply_galois_batch(
        self, c0s: np.ndarray, c1s: np.ndarray, g: int, gk: RelinKey
    ):
        """Batched apply_galois on coeff-domain ct arrays [M, L, N]."""
        perm, sgn = self._automorphism_map(g)
        qs = np.array(self.params.qs, np.int64)[None, :, None]
        c0g = np.mod(c0s[:, :, perm] * sgn[None, None, :], qs)
        c1g = np.mod(c1s[:, :, perm] * sgn[None, None, :], qs)
        ks0, ks1 = self._key_switch_batch(c1g, gk)
        return np.mod(c0g + ks0, qs), ks1

    # -- homomorphic ops -------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.is_ntt != b.is_ntt:
            raise ValueError("add needs both ciphertexts in one domain")
        qs = np.array(self.params.qs, np.int64)[:, None]
        return Ciphertext(
            c0=np.mod(a.c0 + b.c0, qs), c1=np.mod(a.c1 + b.c1, qs),
            is_ntt=a.is_ntt,
        )

    def plain_to_ntt(self, p_coeffs: np.ndarray) -> np.ndarray:
        """Plaintext poly [N] small non-negative ints → NTT-domain [L, N]."""
        return self.ntt_fwd(self._rns_small(p_coeffs.astype(np.int64)))

    def mul_plain_ntt(self, ct: Ciphertext, pt_ntt: np.ndarray) -> Ciphertext:
        """ct × plaintext, both in NTT domain: one pointwise modmul per
        limb (the server-side MAC primitive)."""
        if not ct.is_ntt:
            raise ValueError("mul_plain_ntt needs an NTT-domain ciphertext")
        qs = np.array(self.params.qs, np.int64)[:, None]
        return Ciphertext(
            c0=ct.c0 * pt_ntt % qs, c1=ct.c1 * pt_ntt % qs, is_ntt=True
        )

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
