"""RNS-CKKS approximate homomorphic encryption, host side (numpy only).

The port of prefhetch_tpu/crypto/ckks.py: the client's arithmetic (keygen,
encrypt, decrypt, the Galois keys) and the host oracle's (ct×pt with exact
rescale, rotations with special-modulus key switching) for the slot-packed
encrypted candidate scoring of BASELINE.json config 3 (N=8192, slot
packing). The same seeded rng gives the same keys, ciphertexts and wires
as the JAX package (tests/test_torch_ckks.py).

Implemented from the standard construction (CKKS'17 + RNS variants):

- canonical-embedding encode/decode in O(N log N) via numpy FFT: slot
  values are the evaluations m(ζ^{5^j}) at odd powers of the 2N-th root —
  evaluations at ALL odd powers equal DFT_N(coeffs ⊙ ζ^k), so encode is one
  twisted FFT plus the <5>/<−1> index mapping.
- RLWE keygen/encrypt/decrypt identical in shape to BFV (ternary secret,
  centered-binomial error), message added at scale Δ (no BFV delta-embed).
- ct×pt with exact RNS rescale by the dropped prime.
- slot rotations = Galois automorphism X → X^{5^r}, with key-switching in
  the special-modulus + digit-decomposition form (keys live mod q·p; the
  switch result is exactly divided by p, keeping key-switch noise ≪ Δ).

The server's device program is engine/ckks_device.py; its host twin is
engine/hecompute.py ``CKKSComputeService``.

``DIGIT_BITS`` is a constant here. The JAX package reads it from an
environment variable; in both, the width a key was made at travels in its
wire (``digitBits``) and the server switches with that, so a client that
wants 30-bit digits passes ``digit_bits=30`` to ``galois_keygen``.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from prefhetch_tpu_torch.crypto.bfv import _b64_u32, _u32_b64, tf_uniform_rns
from prefhetch_tpu_torch.crypto.ntt import NTTTables, build_tables, intt, ntt
from prefhetch_tpu_torch.crypto.params import CKKSParams, find_ntt_primes

# Key-switch digit width of the keys this client makes. 15 = two digits per
# 30-bit limb: key-switch noise scales with 2^DIGIT_BITS/p, and at the
# combined response's final 2^5 decode scale 30-bit digits cost ~10x the
# distance error for half the key-switch transforms.
DIGIT_BITS = 15


@dataclasses.dataclass
class CKKSSecretKey:
    s_rns: np.ndarray            # [L+1, N] — s mod each prime in qs + [p]
    s_small: np.ndarray          # [N] ternary (for key generation)


@dataclasses.dataclass
class CKKSPublicKey:
    b_rns: np.ndarray            # [L, N]
    a_rns: np.ndarray            # [L, N]


@dataclasses.dataclass
class GaloisKey:
    """Key-switching key for one automorphism, special-modulus form.

    Component (i, d) switches digit d of limb i: arrays indexed
    [n_limbs·n_digits][L+1, N] over the extended basis qs + [p].
    ``digit_bits`` travels on the wire (``digitBits``), so the server
    switches with the width the client's keys were made at."""

    step: int
    b: np.ndarray                # [n_comp, L+1, N]
    a: np.ndarray                # [n_comp, L+1, N]
    digit_bits: int = DIGIT_BITS

    def to_wire(self) -> dict:
        return {
            "step": self.step, "shape": list(self.b.shape),
            "b": _b64_u32(self.b), "a": _b64_u32(self.a),
            "digitBits": self.digit_bits,
        }

    @staticmethod
    def from_wire(obj: dict) -> "GaloisKey":
        shape = tuple(obj["shape"])
        return GaloisKey(
            step=int(obj["step"]), b=_u32_b64(obj["b"], shape),
            a=_u32_b64(obj["a"], shape),
            digit_bits=int(obj.get("digitBits", DIGIT_BITS)),
        )


@dataclasses.dataclass
class CKKSCiphertext:
    c0: np.ndarray               # [L_cur, N]
    c1: np.ndarray               # [L_cur, N]
    level: int                   # number of active limbs
    scale: float

    def to_wire(self) -> dict:
        return {
            "c0": _b64_u32(self.c0), "c1": _b64_u32(self.c1),
            "shape": list(self.c0.shape),
            "level": self.level, "scale": self.scale,
        }

    @staticmethod
    def from_wire(obj: dict) -> "CKKSCiphertext":
        shape = tuple(obj["shape"])
        return CKKSCiphertext(
            c0=_u32_b64(obj["c0"], shape), c1=_u32_b64(obj["c1"], shape),
            level=int(obj["level"]), scale=float(obj["scale"]),
        )


def _sample_ternary(rng, n):
    return rng.integers(-1, 2, size=n).astype(np.int64)


def _sample_error(rng, n, k=21):
    bits = rng.integers(0, 2, size=(n, 2, k))
    return (bits[:, 0].sum(-1) - bits[:, 1].sum(-1)).astype(np.int64)


def _uniform_rns(rng, n: int, primes: Sequence[int]) -> np.ndarray:
    """[len(primes), N]: one uniform draw below 2^62 per coefficient, taken
    mod each prime (the JAX package's Python-int loop, vectorised: the
    draws are non-negative int64, so ``%`` is the same residue)."""
    a = rng.integers(0, 1 << 62, size=n)
    return np.stack([a % q for q in primes])


def combine_window(d: int, n_blocks: int) -> int:
    """Block spacing of the combined single-ct scoring layout.

    Blocks land at slot offsets W·b with W = d/n_blocks (both powers of
    two). W > 1 lets the IP rotate-accumulate split: strides ≥ W run
    BEFORE the block combine (on every (query, block) row), strides < W
    run AFTER it (on one combined row per query) — the post-combine sum
    over W consecutive slots stays inside block b's [W·b, W·(b+1))
    window. At W = 1 this degenerates to the classic all-rotations-first
    layout (slot j·d + b)."""
    assert d & (d - 1) == 0, "combined layout needs pow2 dimension"
    if n_blocks <= 1:
        return d
    assert n_blocks & (n_blocks - 1) == 0 and n_blocks <= d
    return d // n_blocks


def combined_blocks_padded(p: int, slots: int, d: int) -> int:
    """Pow2-padded block count the combined response tree-merges for p
    candidates of dimension d (matches the server's padding)."""
    per_ct = slots // d
    nb = -(-p // per_ct)
    return 1 << (nb - 1).bit_length() if nb > 1 else 1


def extract_combined_ips(
    slot_vals: np.ndarray, p: int, d: int
) -> np.ndarray:
    """Slot values of a COMBINED scoring response → inner products [p].

    The combined layout (CKKSComputeService.encrypted_scores_combined)
    puts ⟨q, x_{b·per_ct + j}⟩ at slot j·d + W·b, per_ct = slots/d and
    W = combine_window(d, padded blocks)."""
    slots = slot_vals.shape[0]
    per_ct = slots // d
    w = combine_window(d, combined_blocks_padded(p, slots, d))
    b, j = np.divmod(np.arange(p), per_ct)
    return np.real(slot_vals[j * d + w * b]).astype(np.float64)


def rotation_steps(d: int) -> List[int]:
    """The inner-product tree's rotation steps d/2, d/4, …, 1."""
    steps = []
    r = d // 2
    while r >= 1:
        steps.append(r)
        r //= 2
    return steps


class CKKSContext:
    def __init__(self, params: CKKSParams):
        self.params = params
        n = params.n
        # special modulus p: one extra NTT prime below the chain
        all_primes = find_ntt_primes(n, 30, len(params.qs) + 1)
        assert tuple(all_primes[: len(params.qs)]) == tuple(params.qs), (
            "params.qs must be the default descending prime chain"
        )
        self.p = all_primes[-1]
        self.qs: Tuple[int, ...] = tuple(params.qs)
        self.ext: Tuple[int, ...] = self.qs + (self.p,)
        self.tables: List[NTTTables] = [build_tables(q, n) for q in self.ext]
        self.scale = float(1 << params.scale_bits)

        # canonical embedding index mapping: exponent 5^j mod 2N ↔ slot j
        M = 2 * n
        self.rot_group = np.empty(n // 2, np.int64)
        g = 1
        for j in range(n // 2):
            self.rot_group[j] = g
            g = (g * 5) % M
        # ζ^k twist for the odd-power evaluation trick
        self.zeta_pow = np.exp(2j * np.pi * np.arange(n) / M)

        # automorphism permutations cache: step -> (perm, sign)
        self._auto_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._enc_mat_real: np.ndarray | None = None

    # ------------------------------------------------------------------
    # encoding: slots [N/2] complex ↔ real coefficient poly
    def encode(self, values: np.ndarray, scale: float | None = None) -> np.ndarray:
        """values: [≤N/2] (or batched [B, ≤N/2]) real/complex slot values →
        int coeffs [N] / [B, N] (scaled). The batch form is ONE vectorized
        FFT."""
        n = self.params.n
        nh = n // 2
        scale = scale or self.scale
        v = np.asarray(values)
        squeeze = v.ndim == 1
        if squeeze:
            v = v[None]
        z = np.zeros((v.shape[0], nh), np.complex128)
        z[:, : v.shape[1]] = v
        # full odd-power spectrum V[i], exponent e_i = 2i+1
        V = np.zeros((v.shape[0], n), np.complex128)
        idx = (self.rot_group - 1) // 2          # position of exponent 5^j
        conj_idx = (2 * n - self.rot_group - 1) // 2
        V[:, idx] = z
        V[:, conj_idx] = np.conj(z)
        t = np.fft.fft(V, axis=1) / n            # t_k = c_k ζ^k
        coeffs = np.real(t * np.conj(self.zeta_pow)[None])
        out = np.round(coeffs * scale).astype(np.int64)
        return out[0] if squeeze else out

    def encode_matrix_real(self) -> np.ndarray:
        """The linear form of `encode` restricted to REAL slot vectors:
        a [N/2, N] f32 matrix M with encode(z) == round((z @ M) · scale)
        (bit-exact against encode() at f64). The server runs the candidate
        encode as one matmul against it (engine/ckks_device.py).
        Derivation: the encode spectrum satisfies V[n−1−m] = conj(V[m]), so
        for real z the k-th coefficient collapses to
        (2/n)·Σ_s z_s·cos(2πk(m_s+½)/n), m_s = (rot_group_s−1)/2. Cached on
        the context (~134 MB at N=8192); |M| ≤ 2/n keeps
        |coeff| ≤ scale·max|z| (the caller's int32 bound)."""
        m = self._enc_mat_real
        if m is None:
            n = self.params.n
            m_s = ((self.rot_group - 1) // 2).astype(np.float64) + 0.5
            k = np.arange(n, dtype=np.float64)
            m = np.empty((n // 2, n), np.float32)
            for r0 in range(0, n // 2, 256):        # bound f64 peak memory
                r1 = min(r0 + 256, n // 2)
                ang = (2.0 * np.pi / n) * np.outer(m_s[r0:r1], k)
                m[r0:r1] = ((2.0 / n) * np.cos(ang)).astype(np.float32)
            self._enc_mat_real = m
        return m

    def decode(self, coeffs: np.ndarray, scale: float) -> np.ndarray:
        """Signed int coeffs [N] → slot values [N/2] complex."""
        n = self.params.n
        t = coeffs.astype(np.float64) * self.zeta_pow
        V = np.fft.ifft(t) * n
        idx = (self.rot_group - 1) // 2
        return V[idx] / scale

    # ------------------------------------------------------------------
    def _to_rns(self, small: np.ndarray, n_limbs: int | None = None) -> np.ndarray:
        primes = self.ext if n_limbs is None else self.ext[:n_limbs]
        qs = np.array(primes, np.int64)[:, None]
        return np.mod(small[None, :].astype(np.int64), qs)

    def _polymul(self, a: np.ndarray, b: np.ndarray, primes: Sequence[int]) -> np.ndarray:
        out = np.empty_like(a)
        for i, q in enumerate(primes):
            tb = self.tables[self.ext.index(q)]
            out[i] = intt(ntt(a[i], tb) * ntt(b[i], tb) % q, tb)
        return out

    # ------------------------------------------------------------------
    def keygen(self, rng) -> Tuple[CKKSSecretKey, CKKSPublicKey]:
        n = self.params.n
        s = _sample_ternary(rng, n)
        s_rns = self._to_rns(s)
        e = self._to_rns(_sample_error(rng, n))
        L = len(self.qs)
        a_rns = _uniform_rns(rng, n, self.qs)
        qs = np.array(self.qs, np.int64)[:, None]
        b_rns = np.mod(
            -(self._polymul(a_rns, s_rns[:L], self.qs) + e[:L]), qs
        )
        return CKKSSecretKey(s_rns=s_rns, s_small=s), CKKSPublicKey(
            b_rns=b_rns, a_rns=a_rns
        )

    def encrypt(
        self, pk: CKKSPublicKey, pt_coeffs: np.ndarray, rng,
        scale: float | None = None,
    ) -> CKKSCiphertext:
        """pt_coeffs: signed int64 [N] (already scaled — pass the matching
        `scale` when it differs from the context default Δ)."""
        L = len(self.qs)
        u = self._to_rns(_sample_ternary(rng, self.params.n), L)
        e1 = self._to_rns(_sample_error(rng, self.params.n), L)
        e2 = self._to_rns(_sample_error(rng, self.params.n), L)
        m = self._to_rns(pt_coeffs, L)
        qs = np.array(self.qs, np.int64)[:, None]
        c0 = np.mod(self._polymul(pk.b_rns, u, self.qs) + e1 + m, qs)
        c1 = np.mod(self._polymul(pk.a_rns, u, self.qs) + e2, qs)
        return CKKSCiphertext(
            c0=c0, c1=c1, level=L, scale=scale or self.scale
        )

    def encrypt_symmetric_tf(
        self, sk: CKKSSecretKey, pt_coeffs: np.ndarray, rng,
        scale: float | None = None,
    ) -> dict:
        """Seeded symmetric encryption with a device-expandable mask:
        c1 = a drawn with the threefry2x32 counter PRF
        (crypto/bfv.tf_uniform_rns), c0 = −a·s + m + e. The wire carries c0
        and an 8-byte key instead of both components; the server
        regenerates c1 inside its device program (ops/threefry.py), halving
        the query upload. Same PRG-assumption note as
        bfv.encrypt_symmetric_batch_ntt_tf."""
        L = len(self.qs)
        key = rng.integers(0, 1 << 32, size=2, dtype=np.uint32)
        a = tf_uniform_rns(key, self.qs, self.params.n)
        e = self._to_rns(_sample_error(rng, self.params.n), L)
        m = self._to_rns(pt_coeffs, L)
        qs = np.array(self.qs, np.int64)[:, None]
        c0 = np.mod(m + e - self._polymul(a, sk.s_rns[:L], self.qs), qs)
        return {
            "c0": _b64_u32(c0),
            "seedTf": [int(key[0]), int(key[1])],
            "shape": [L, self.params.n],
            "level": L,
            "scale": float(scale or self.scale),
        }

    def ct_from_wire(self, obj: dict) -> CKKSCiphertext:
        """Wire → CKKSCiphertext, expanding seedTf symmetric forms."""
        if "seedTf" not in obj:
            return CKKSCiphertext.from_wire(obj)
        shape = tuple(obj["shape"])
        c0 = _u32_b64(obj["c0"], shape)
        c1 = tf_uniform_rns(np.asarray(obj["seedTf"], np.uint32),
                            self.qs[: shape[0]], self.params.n)
        return CKKSCiphertext(
            c0=c0, c1=c1, level=int(obj["level"]),
            scale=float(obj["scale"]),
        )

    def decrypt_coeffs(self, sk: CKKSSecretKey, ct: CKKSCiphertext) -> np.ndarray:
        """→ signed big-int coefficient vector [N] (CRT-composed, centered)."""
        primes = self.qs[: ct.level]
        qs = np.array(primes, np.int64)[:, None]
        v = np.mod(
            ct.c0 + self._polymul(ct.c1, sk.s_rns[: ct.level], primes), qs
        )
        return self._crt_center(v, primes)

    def decrypt(self, sk: CKKSSecretKey, ct: CKKSCiphertext) -> np.ndarray:
        """→ slot values [N/2]."""
        coeffs = self.decrypt_coeffs(sk, ct)
        return self.decode(coeffs.astype(np.float64), ct.scale)

    def _crt_center(self, v: np.ndarray, primes: Sequence[int]) -> np.ndarray:
        q = 1
        for qi in primes:
            q *= qi
        acc = np.zeros(self.params.n, object)
        for i, qi in enumerate(primes):
            qhat = q // qi
            inv = pow(qhat % qi, -1, qi)
            acc += qhat * ((v[i].astype(object) * inv) % qi)
        acc %= q
        return np.where(acc > q // 2, acc - q, acc)

    # ------------------------------------------------------------------
    def add(self, x: CKKSCiphertext, y: CKKSCiphertext) -> CKKSCiphertext:
        assert x.level == y.level and abs(x.scale - y.scale) < 1e-6
        qs = np.array(self.qs[: x.level], np.int64)[:, None]
        return CKKSCiphertext(
            c0=np.mod(x.c0 + y.c0, qs), c1=np.mod(x.c1 + y.c1, qs),
            level=x.level, scale=x.scale,
        )

    def mul_plain(
        self, ct: CKKSCiphertext, pt_coeffs: np.ndarray, pt_scale: float
    ) -> CKKSCiphertext:
        """ct × plaintext poly (signed ints, scaled by pt_scale); rescales."""
        primes = self.qs[: ct.level]
        p_rns = self._to_rns(pt_coeffs, ct.level)
        c0 = self._polymul(ct.c0, p_rns, primes)
        c1 = self._polymul(ct.c1, p_rns, primes)
        out = CKKSCiphertext(
            c0=c0, c1=c1, level=ct.level, scale=ct.scale * pt_scale
        )
        return self.rescale(out)

    def rescale(self, ct: CKKSCiphertext) -> CKKSCiphertext:
        """Exact RNS rescale: drop the last active prime q_l, dividing."""
        l = ct.level - 1
        ql = self.qs[l]
        out0 = np.empty((l, self.params.n), np.int64)
        out1 = np.empty_like(out0)
        for i in range(l):
            qi = self.qs[i]
            inv_ql = pow(ql, -1, qi)
            out0[i] = (ct.c0[i] - ct.c0[l]) % qi * inv_ql % qi
            out1[i] = (ct.c1[i] - ct.c1[l]) % qi * inv_ql % qi
        return CKKSCiphertext(
            c0=out0, c1=out1, level=l, scale=ct.scale / ql
        )

    def mul(
        self, x: CKKSCiphertext, y: CKKSCiphertext, rk: GaloisKey
    ) -> CKKSCiphertext:
        """ct × ct with relinearization + rescale.

        Tensor product (d0, d1, d2) = (x0·y0, x0·y1 + x1·y0, x1·y1); the
        quadratic term d2·s² is switched back to degree 1 with the
        relinearization key (the key-switch machinery of rotations, with s²
        in place of s(X^g))."""
        assert x.level == y.level
        level = x.level
        primes = self.qs[:level]
        qs = np.array(primes, np.int64)[:, None]
        d0 = self._polymul(x.c0, y.c0, primes)
        d1 = np.mod(
            self._polymul(x.c0, y.c1, primes)
            + self._polymul(x.c1, y.c0, primes),
            qs,
        )
        d2 = self._polymul(x.c1, y.c1, primes)
        ks0, ks1 = self._key_switch(d2, rk, level)
        out = CKKSCiphertext(
            c0=np.mod(d0 + ks0, qs),
            c1=np.mod(d1 + ks1, qs),
            level=level,
            scale=x.scale * y.scale,
        )
        return self.rescale(out)

    def relin_keygen(self, sk: CKKSSecretKey, rng,
                     digit_bits: int = DIGIT_BITS) -> GaloisKey:
        """Relinearization key: key-switching key for s² (packaged in the
        GaloisKey container with step = -1)."""
        s2 = self._polymul(sk.s_rns, sk.s_rns, self.ext)   # s² mod each prime
        return self._make_switch_key(s2, sk, rng, step=-1,
                                     digit_bits=digit_bits)

    def _make_switch_key(self, target_rns, sk, rng, step,
                         digit_bits: int = DIGIT_BITS):
        """Generic key-switching key: encrypts `target` (given in RNS over
        the extended basis) under s, P-scaled, digit-decomposed."""
        n = self.params.n
        L = len(self.qs)
        n_digits = -(-30 // digit_bits)
        ext = self.ext
        qs_ext = np.array(ext, np.int64)[:, None]
        big_q = 1
        for q in self.qs:
            big_q *= q
        comps_b, comps_a = [], []
        for i in range(L):
            qi = self.qs[i]
            qhat = big_q // qi
            Pi = qhat * pow(qhat % qi, -1, qi) % big_q
            for d in range(n_digits):
                W = 1 << (d * digit_bits)
                factor = Pi * W * self.p % (big_q * self.p)
                fac_rns = np.array([factor % q for q in ext], np.int64)[:, None]
                a_rns = _uniform_rns(rng, n, ext)
                e_rns = self._to_rns(_sample_error(rng, n))
                b_rns = np.mod(
                    -(self._polymul(a_rns, sk.s_rns, ext) + e_rns)
                    + fac_rns * target_rns % qs_ext,
                    qs_ext,
                )
                comps_b.append(b_rns)
                comps_a.append(a_rns)
        return GaloisKey(
            step=step, b=np.stack(comps_b), a=np.stack(comps_a),
            digit_bits=digit_bits,
        )

    def _key_switch(self, poly: np.ndarray, key: GaloisKey, level: int):
        """Switch `poly`·(key target) into (c0, c1) under s: digit-decompose,
        multiply key components over the extended basis, divide by p.

        NTT-batched: by linearity, Σ_c INTT(NTT(d_c)⊙NTT(k_c)) =
        INTT(Σ_c NTT(d_c)⊙NTT(k_c)) — all component forward NTTs run as one
        batch per prime and a single inverse NTT closes the sum."""
        n = self.params.n
        primes = self.qs[:level]
        # digit width travels WITH the key (wire-negotiated)
        dbits = key.digit_bits
        n_digits = -(-30 // dbits)
        mask = (1 << dbits) - 1
        ext_primes = primes + (self.p,)
        n_ext = len(ext_primes)
        rows = [self.ext.index(q) for q in ext_primes]
        n_comp = level * n_digits
        # digits [n_comp, N] — small positive ints, same value every prime
        digits = np.empty((n_comp, n), np.int64)
        for i in range(level):
            limb = poly[i]
            for d in range(n_digits):
                digits[i * n_digits + d] = (limb >> (d * dbits)) & mask
        comp_rows = [i * n_digits + d for i in range(level)
                     for d in range(n_digits)]
        acc0 = np.empty((n_ext, n), np.int64)
        acc1 = np.empty((n_ext, n), np.int64)
        for e, q in enumerate(ext_primes):
            tb = self.tables[self.ext.index(q)]
            D = ntt(digits % q, tb)                       # [n_comp, N] batch
            Kb = ntt(key.b[comp_rows, rows[e]] % q, tb)   # [n_comp, N]
            Ka = ntt(key.a[comp_rows, rows[e]] % q, tb)
            acc0[e] = intt(np.sum(D * Kb % q, axis=0) % q, tb)
            acc1[e] = intt(np.sum(D * Ka % q, axis=0) % q, tb)
        out0 = np.empty((level, n), np.int64)
        out1 = np.empty_like(out0)
        half_p = self.p // 2
        cp0 = np.where(acc0[-1] > half_p, acc0[-1] - self.p, acc0[-1])
        cp1 = np.where(acc1[-1] > half_p, acc1[-1] - self.p, acc1[-1])
        for i in range(level):
            qi = primes[i]
            inv_p = pow(self.p, -1, qi)
            out0[i] = (acc0[i] - cp0) % qi * inv_p % qi
            out1[i] = (acc1[i] - cp1) % qi * inv_p % qi
        return out0, out1

    # ------------------------------------------------------------------
    # rotations
    def _automorphism_map(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Permutation/sign arrays for X → X^{5^step} on coefficient vectors:
        out[(k·g) mod N] = ± in[k]."""
        if step in self._auto_cache:
            return self._auto_cache[step]
        n = self.params.n
        M = 2 * n
        g = pow(5, step % (n // 2), M)
        k = np.arange(n)
        kg = (k * g) % M
        dest = kg % n
        sign = np.where(kg < n, 1, -1).astype(np.int64)
        perm = np.empty(n, np.int64)
        sgn = np.empty(n, np.int64)
        perm[dest] = k
        sgn[dest] = sign
        self._auto_cache[step] = (perm, sgn)
        return perm, sgn

    def _apply_auto(self, poly: np.ndarray, step: int, primes) -> np.ndarray:
        perm, sgn = self._automorphism_map(step)
        qs = np.array(primes, np.int64)[:, None]
        return np.mod(poly[:, perm] * sgn[None, :], qs)

    def galois_keygen(self, sk: CKKSSecretKey, steps: Sequence[int], rng,
                      digit_bits: int = DIGIT_BITS) -> Dict[int, GaloisKey]:
        """Key-switching keys for slot rotations by each step (the key embeds
        p·s(X^{5^step}) so the post-switch division by p leaves the rotated
        secret intact while shrinking the key-switch error)."""
        out = {}
        for step in steps:
            perm, sgn = self._automorphism_map(step)
            s_rot = sk.s_small[perm] * sgn       # s(X^g), small ints
            out[step] = self._make_switch_key(
                self._to_rns(s_rot), sk, rng, step=step,
                digit_bits=digit_bits,
            )
        return out

    def combine_tree_steps(self, n_blocks: int, d: int) -> List[int]:
        """Rotation steps (−W, −2W, …, W = combine_window(d, n_blocks)) a
        client must provide Galois keys for to receive the combined
        single-ct scoring response
        (engine.hecompute.CKKSComputeService.encrypted_scores_combined)."""
        if n_blocks <= 1:
            return []
        w = combine_window(d, n_blocks)
        return [-(w << k) for k in range((n_blocks - 1).bit_length())]

    def rotate(self, ct: CKKSCiphertext, step: int, gk: GaloisKey) -> CKKSCiphertext:
        """Rotate slots left by `step` positions: apply the automorphism to
        both components, then key-switch c1(X^g)·s(X^g) back under s."""
        level = ct.level
        primes = self.qs[:level]
        c0r = self._apply_auto(ct.c0, step, primes)
        c1r = self._apply_auto(ct.c1, step, primes)
        ks0, ks1 = self._key_switch(c1r, gk, level)
        return CKKSCiphertext(
            c0=np.mod(c0r + ks0, np.array(primes, np.int64)[:, None]),
            c1=ks1,
            level=level,
            scale=ct.scale,
        )
