"""The BFV client of the packed re-rank wire: keygen, extraction keys,
threefry-seeded query encryption and packed-response decryption.

numpy only, transforms by the numpy butterfly. Every function is a frozen
copy of the client-side path of prefhetch_tpu_torch/client/he.py
(``HEClient`` with ``resp_mod="packed"``) and the pieces of crypto/params.py,
crypto/ntt.py, crypto/bfv.py and crypto/packing.py that it runs, named in
each docstring. Keys come from a numpy generator seeded by the run, so the
same seed gives the same keys and wires.
"""

from __future__ import annotations

import base64
import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np


# -- parameters (crypto/params.py) -------------------------------------------

def _is_prime(n: int) -> bool:
    """Copy of crypto/params.py ``_is_prime`` (deterministic Miller-Rabin)."""
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
    """Copy of crypto/params.py ``find_ntt_primes``: ``count`` primes
    q ≡ 1 (mod 2·n_poly) below 2^bits, descending."""
    m = 2 * n_poly
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
    """Copy of crypto/params.py ``_primitive_root``."""
    phi = q - 1
    factors = []
    x, d = phi, 2
    while d * d <= x:
        if x % d == 0:
            factors.append(d)
            while x % d == 0:
                x //= d
        d += 1
    if x > 1:
        factors.append(x)
    g = 2
    while not all(pow(g, phi // f, q) != 1 for f in factors):
        g += 1
    return g


def root_of_unity(q: int, order: int) -> int:
    """Copy of crypto/params.py ``root_of_unity``."""
    return pow(_primitive_root(q), (q - 1) // order, q)


class Params(NamedTuple):
    n: int
    t: int
    qs: Tuple[int, ...]

    @property
    def q(self) -> int:
        out = 1
        for qi in self.qs:
            out *= qi
        return out


def bfv_params(n: int, t_bits: int, n_limbs: int, odd_t: bool) -> Params:
    """Copy of crypto/params.py ``bfv_params_for``: t = 2^t_bits (+1 for
    the packed response, which needs an odd t)."""
    return Params(n=n, t=(1 << t_bits) + (1 if odd_t else 0),
                  qs=tuple(find_ntt_primes(n, 30, n_limbs)))


# -- the butterfly NTT (crypto/ntt.py ntt_plain / intt_plain) ----------------

class Tables(NamedTuple):
    q: int
    n: int
    psi_pows: np.ndarray
    ipsi_pows: np.ndarray
    stage_tw: Tuple[np.ndarray, ...]
    stage_itw: Tuple[np.ndarray, ...]
    bitrev: np.ndarray


@functools.lru_cache(maxsize=None)
def tables(q: int, n: int) -> Tables:
    """Copy of crypto/ntt.py ``build_tables``."""
    logn = n.bit_length() - 1
    psi = root_of_unity(q, 2 * n)
    omega = psi * psi % q
    inv_psi, inv_omega, inv_n = pow(psi, -1, q), pow(omega, -1, q), pow(n, -1, q)
    psi_pows = np.array([pow(psi, i, q) for i in range(n)], np.int64)
    ipsi = np.array([pow(inv_psi, i, q) * inv_n % q for i in range(n)],
                    np.int64)
    idx = np.arange(n)
    bitrev = np.zeros(n, np.int64)
    for b in range(logn):
        bitrev |= ((idx >> b) & 1) << (logn - 1 - b)
    tw, itw = [], []
    for s in range(logn):
        m = 1 << s
        w = pow(omega, n // (2 * m), q)
        iw = pow(inv_omega, n // (2 * m), q)
        tw.append(np.array([pow(w, j, q) for j in range(m)], np.int64))
        itw.append(np.array([pow(iw, j, q) for j in range(m)], np.int64))
    return Tables(q, n, psi_pows, ipsi, tuple(tw), tuple(itw), bitrev)


def _cyclic(x: np.ndarray, tb: Tables, inverse: bool) -> np.ndarray:
    """Copy of crypto/ntt.py ``_cyclic_ntt_core``."""
    q, n = tb.q, tb.n
    batch = x.shape[:-1]
    x = x[..., tb.bitrev]
    tws = tb.stage_itw if inverse else tb.stage_tw
    for s in range(n.bit_length() - 1):
        m = 1 << s
        y = x.reshape(*batch, n // (2 * m), 2, m)
        even = y[..., 0, :]
        odd = y[..., 1, :] * tws[s] % q
        x = np.concatenate([(even + odd) % q, (even - odd) % q], axis=-1)
        x = x.reshape(*batch, n)
    return x


def ntt(x: np.ndarray, tb: Tables) -> np.ndarray:
    """Copy of crypto/ntt.py ``ntt_plain`` (values taken mod q first)."""
    x = np.mod(np.asarray(x, np.int64), tb.q)
    return _cyclic(x * tb.psi_pows % tb.q, tb, inverse=False)


def intt(x: np.ndarray, tb: Tables) -> np.ndarray:
    """Copy of crypto/ntt.py ``intt_plain``."""
    y = _cyclic(np.mod(np.asarray(x, np.int64), tb.q), tb, inverse=True)
    return y * tb.ipsi_pows % tb.q


# -- wires and samplers (crypto/bfv.py) ---------------------------------------

def _b64_u32(x: np.ndarray) -> str:
    """Copy of crypto/bfv.py ``_b64_u32``."""
    return base64.b64encode(
        np.ascontiguousarray(x.astype("<u4")).tobytes()).decode()


def _u32_b64(s: str, shape) -> np.ndarray:
    """Copy of crypto/bfv.py ``_u32_b64``."""
    return np.frombuffer(base64.b64decode(s), dtype="<u4").astype(
        np.int64).reshape(shape)


_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32_20(k0, k1, x0, x1):
    """Copy of crypto/bfv.py ``_threefry2x32_20``."""
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
    """Copy of crypto/bfv.py ``tf_uniform_rns``: the [L, N] public mask of
    a ``seedTf`` wire from its two-word threefry key."""
    L = len(qs)
    total = L * n
    kd = np.asarray(key_data, np.uint32)
    cnt = np.arange(2 * total, dtype=np.uint32)
    with np.errstate(over="ignore"):
        o0, o1 = _threefry2x32_20(kd[0], kd[1], cnt[:total], cnt[total:])
    hi = (o0 >> np.uint32(2)).astype(np.int64)
    lo = o1.astype(np.int64)
    v = ((hi << 32) | lo).reshape(L, n)
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


def _sample_error(rng: np.random.Generator, shape) -> np.ndarray:
    """Copy of crypto/bfv.py ``_sample_error`` (centred binomial, σ≈3.2)."""
    return (rng.binomial(21, 0.5, size=shape).astype(np.int64)
            - rng.binomial(21, 0.5, size=shape).astype(np.int64))


# -- the client ----------------------------------------------------------------

class PackedClient:
    """One user of the packed BFV re-rank: a secret key, the extraction
    keys the server needs once, seeded query wires and packed decryption
    (client/he.py ``HEClient`` with ``resp_mod="packed"``)."""

    def __init__(self, n: int, t_bits: int, n_limbs: int, seed: int,
                 key_id: str):
        self.params = bfv_params(n, t_bits, n_limbs, odd_t=True)
        self.tables = [tables(q, n) for q in self.params.qs]
        self.key_id = key_id
        self._rng = np.random.default_rng(seed)
        s = self._rng.integers(-1, 2, size=n).astype(np.int64)
        self._s_signed = s
        self.s_rns = np.mod(s[None], np.array(self.params.qs, np.int64)[:, None])
        q, t = self.params.q, self.params.t
        self._delta = np.array([(q // t) % qi for qi in self.params.qs],
                               np.int64)

    # -- extraction keys (client/he.py bfv_extraction_keys_wire) -----------
    def _special_p(self) -> int:
        """Copy of crypto/bfv.py ``_ext_basis`` + ``_special_p``: the key
        switch's special prime, outside the tensoring basis."""
        p = self.params
        L = len(p.qs)
        need = p.q.bit_length() * 2 + p.n.bit_length() + 2
        n_extra = -(-max(0, need - 30 * L) // 29)
        allp = find_ntt_primes(p.n, 30, L + n_extra + 1)
        ext = tuple(p.qs) + tuple(x for x in allp if x not in p.qs)[: n_extra + 1]
        return [x for x in find_ntt_primes(p.n, 30, len(ext) + 2)
                if x not in ext][0]

    def _switch_key(self, target: np.ndarray, sp: int, digit_bits: int) -> dict:
        """Copy of crypto/bfv.py ``_make_switch_key`` → its wire
        (``RelinKey.to_wire``)."""
        p = self.params
        ext = tuple(p.qs) + (sp,)
        ext_tb = [tables(q, p.n) for q in ext]
        qs_ext = np.array(ext, np.int64)[:, None]

        def polymul(a, b):
            return np.stack([intt(ntt(a[i], tb) * ntt(b[i], tb) % tb.q, tb)
                             for i, tb in enumerate(ext_tb)])

        s_ext = np.mod(self._s_signed[None], qs_ext)
        target_ext = np.mod(target[None], qs_ext)
        n_digits = -(-30 // digit_bits)
        big_q = p.q
        bs, as_ = [], []
        for qi in p.qs:
            qhat = big_q // qi
            Pi = qhat * pow(qhat % qi, -1, qi) % big_q
            for d in range(n_digits):
                factor = Pi * (1 << (d * digit_bits)) * sp % (big_q * sp)
                fac = np.array([factor % q for q in ext], np.int64)[:, None]
                a = np.mod(self._rng.integers(0, 1 << 62, size=p.n)[None],
                           qs_ext)
                e = np.mod(_sample_error(self._rng, p.n)[None], qs_ext)
                b = np.mod(-(polymul(a, s_ext) + e) + fac * target_ext % qs_ext,
                           qs_ext)
                bs.append(b)
                as_.append(a)
        b, a = np.stack(bs), np.stack(as_)
        return {"specialP": sp, "ext": list(ext), "shape": list(b.shape),
                "b": _b64_u32(b), "a": _b64_u32(a), "digitBits": digit_bits}

    def extraction_keys_wire(self, d: int) -> Dict[str, dict]:
        """Copy of client/he.py ``bfv_extraction_keys_wire`` with
        crypto/bfv.py ``extraction_elts`` and ``galois_keygen``: the
        log2(d) Galois keys g_r = N/2^r + 1, 30-bit digits."""
        n = self.params.n
        rounds = (d - 1).bit_length()
        if 1 << rounds != d:
            raise ValueError("extraction needs a power-of-two stride d")
        sp = self._special_p()
        out = {}
        k = np.arange(n)
        for g in [n // (1 << r) + 1 for r in range(rounds)]:
            kg = (k * g) % (2 * n)
            s_rot = np.zeros(n, np.int64)
            s_rot[kg % n] = self._s_signed * np.where(kg < n, 1, -1)
            out[str(g)] = self._switch_key(s_rot, sp, digit_bits=30)
        return out

    # -- encrypt (client/he.py encrypt_query_batch, packed) -----------------
    def encrypt_batch(self, queries: np.ndarray) -> List[dict]:
        """Copy of crypto/packing.py ``encode_query_poly`` and crypto/bfv.py
        ``encrypt_symmetric_batch_ntt_tf``: seeded symmetric NTT-domain wires
        (c0 and an 8-byte threefry key a query)."""
        p = self.params
        B, d = queries.shape
        qi = np.round(queries).astype(np.int64)
        if np.abs(qi).max(initial=0) >= p.t // 2:
            raise ValueError("query exceeds the plaintext half-window")
        ms = np.zeros((B, p.n), np.int64)
        ms[:, :d] = qi % p.t
        qs = np.array(p.qs, np.int64)[:, None, None]
        e = _sample_error(self._rng, (B, p.n))
        e_rns = np.mod(e[None], qs)
        dm = self._delta[:, None, None] * np.mod(ms[None], p.t) % qs
        keys = self._rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint32)
        a_rns = np.stack([tf_uniform_rns(keys[b], p.qs, p.n)
                          for b in range(B)])
        c0 = np.empty((B, len(p.qs), p.n), np.int64)
        for i, tb in enumerate(self.tables):
            q = tb.q
            s_ntt = ntt(self.s_rns[i], tb)
            a_ntt = ntt(a_rns[:, i], tb)
            body = np.mod(dm[i] - e_rns[i], q)
            c0[:, i] = (q - a_ntt * s_ntt % q + ntt(body, tb)) % q
        return [{"c0": _b64_u32(c0[b]),
                 "seedTf": [int(keys[b, 0]), int(keys[b, 1])],
                 "shape": [len(p.qs), p.n], "isNtt": True, "scheme": "bfv"}
                for b in range(B)]

    # -- decrypt (client/he.py decrypt_scores_packed) ------------------------
    def decrypt_batch(self, cts: List[Tuple[np.ndarray, np.ndarray]]
                      ) -> np.ndarray:
        """Copy of crypto/bfv.py ``decrypt_batch`` for coefficient-domain
        (c0, c1) pairs [L, N] → plaintexts [B, N] in [0, t)."""
        p = self.params
        c0 = np.stack([c[0] for c in cts])
        c1 = np.stack([c[1] for c in cts])
        frac = np.zeros((len(cts), p.n), np.float64)
        for i, tb in enumerate(self.tables):
            q = tb.q
            s_ntt = ntt(self.s_rns[i], tb)
            v = intt((ntt(c0[:, i], tb) + ntt(c1[:, i], tb) * s_ntt % q) % q,
                     tb)
            inv = pow((p.q // q) % q, -1, q)
            frac += ((v * inv) % q).astype(np.float64) / q
        frac -= np.floor(frac)
        return np.round(p.t * frac).astype(np.int64) % p.t

    def decrypt_packed(self, response: dict, queries: np.ndarray) -> np.ndarray:
        """A packed /encryptedsearch response → squared-L2 distances [nq, P]
        float64 (client/he.py ``decrypt_scores_packed`` and ``_distances``,
        crypto/packing.py ``distances_from_inner_products``)."""
        p = self.params
        norms = np.asarray(response["candidateNorms"], np.float64)
        G = int(response["packGroup"])
        cts = []
        for w in response["packedScores"]:
            shape = tuple(w["shape"])
            if w.get("isNtt"):
                raise ValueError("packed response must be coefficient-domain")
            cts.append((_u32_b64(w["c0"], shape), _u32_b64(w["c1"], shape)))
        nq, P = norms.shape
        d = queries.shape[1]
        B = p.n // d
        nb = -(-P // B)
        msgs = self.decrypt_batch(cts)
        qi = np.arange(nq)[:, None, None]
        b = np.arange(nb)[None, :, None]
        j = np.arange(B)[None, None, :]
        ips = msgs[qi // G, j * d + (qi % G) * nb + b]
        ips = ips.reshape(nq, nb * B) * pow(d % p.t, -1, p.t) % p.t
        ips = np.where(ips > p.t // 2, ips - p.t, ips)[:, :P]
        qsq = (np.round(queries).astype(np.int64) ** 2).sum(1).astype(np.float64)
        return qsq[:, None] - 2.0 * ips.astype(np.float64) + norms
