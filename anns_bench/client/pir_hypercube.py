"""The client of the 2-D hypercube PIR wire (``/pir-fetch``
``pirHypercubeMulti``): keygen, the Galois expansion keys, multi-row
queries and the decoding of their responses.

numpy only. Every function is a frozen copy of the client-side path of
prefhetch_tpu_torch/crypto/pir.py ``PIRClient`` (``build_query_2d_multi``,
``galois_keys_wire_2d_multi``, ``decode_response_2d``) and of the pieces of
crypto/bfv.py it runs (``keygen``, ``encrypt``, ``galois_keygen``), named in
each docstring; the parameter, transform, wire and key-switch pieces it
shares with the packed re-rank's client come from client/bfv.py. Keys and
encryption noise come from a numpy generator seeded by the run and are drawn
in the program's order, so a seed gives the program's client's wires.

The decryption of a response is vectorised: the negacyclic product by the
ternary secret is one float64 matrix product (every partial sum of residues
below 2^30 times ±1 stays below 2^53, so it is exact), in place of the
program's transform per ciphertext; the numbers are the same.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from anns_bench.client.bfv import (
    PackedClient, Params, _b64_u32, _sample_error, find_ntt_primes, intt,
    ntt, tables,
)


def grid_dims(n: int, nbase: int, d: int) -> Tuple[int, int, int]:
    """Copy of crypto/pir.py ``grid_dims``: (G, G1, G2) of the hypercube."""
    R = n // d
    G = -(-nbase // R)
    g1 = int(np.ceil(np.sqrt(G)))
    g2 = -(-G // g1)
    return G, g1, g2


def expansion_elts(n: int, m: int) -> List[int]:
    """Copy of crypto/pir.py ``expansion_galois_elements``."""
    logm = max(1, (m - 1).bit_length())
    return [(n >> j) + 1 for j in range(logm)]


def unpack_i32(obj: dict) -> np.ndarray:
    """Copy of utils/wire.py ``unpack_i32``."""
    import base64

    raw = base64.b64decode(obj["b64"])
    a = np.frombuffer(raw, dtype="<i4")
    shape = [int(s) for s in obj["shape"]]
    if a.size != int(np.prod(shape)):
        raise ValueError("wire array size does not match declared shape")
    return a.reshape(shape).astype(np.int32)


class Client(PackedClient):
    """One user of the PIR fetch: a key pair, the expansion keys the server
    needs once, multi-row query wires and their decoding (crypto/pir.py
    ``PIRClient`` at ``pir_params_for(n, t, n_limbs)``)."""

    def __init__(self, n: int, t: int, n_limbs: int, seed: int,
                 key_id: str):
        # crypto/params.py pir_params_for; crypto/bfv.py keygen with
        # crypto/rng.py secure_rng(seed): s, e, then a coefficient by
        # coefficient
        self.params = Params(n=n, t=t, qs=tuple(find_ntt_primes(n, 30,
                                                                n_limbs)))
        self.tables = [tables(q, n) for q in self.params.qs]
        self.key_id = key_id
        self._rng = np.random.default_rng(seed)
        p = self.params
        qs = np.array(p.qs, np.int64)[:, None]
        s = self._rng.integers(-1, 2, size=n).astype(np.int64)
        e = _sample_error(self._rng, n)
        a_int = [int(self._rng.integers(0, 1 << 62)) % p.q for _ in range(n)]
        a_rns = np.array([[c % q for c in a_int] for q in p.qs], np.int64)
        self._s_signed = s
        self.s_rns = np.mod(s[None], qs)
        self._b_rns = np.mod(-(self._polymul(a_rns, self.s_rns)
                               + np.mod(e[None], qs)), qs)
        self._a_rns = a_rns
        self._delta = np.array([(p.q // t) % q for q in p.qs], np.int64)
        self._gks: dict = {}
        self._negacyclic = None

    def _polymul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Copy of crypto/bfv.py ``BFVContext._polymul``: [L, N] ⊙ [L, N]."""
        return np.stack([intt(ntt(a[i], tb) * ntt(b[i], tb) % tb.q, tb)
                         for i, tb in enumerate(self.tables)])

    # -- the Galois expansion keys (galois_keys_wire_2d_multi) --------------
    def galois_keys_wire(self, nbase: int, d: int, n_rows: int) -> dict:
        """Copy of crypto/pir.py ``galois_keys_wire_2d_multi`` with
        crypto/bfv.py ``galois_keygen`` (15-bit digits): the keys of the
        n_rows·m selector expansion, the service's extension basis and
        special prime."""
        n = self.params.n
        _, g1, g2 = grid_dims(n, nbase, d)
        elts = expansion_elts(n, n_rows * (g1 + g2))
        missing = [g for g in elts if g not in self._gks]
        if missing:
            sp = self._special_p()
            k = np.arange(n)
            for g in missing:
                kg = (k * g) % (2 * n)
                s_rot = np.zeros(n, np.int64)
                s_rot[kg % n] = self._s_signed * np.where(kg < n, 1, -1)
                self._gks[g] = self._switch_key(s_rot, sp, digit_bits=15)
        return {str(g): self._gks[g] for g in elts}

    # -- queries (build_query_2d_multi) --------------------------------------
    def _encrypt_batch(self, ms: np.ndarray) -> List[dict]:
        """crypto/bfv.py ``BFVContext.encrypt`` of each plaintext of ms
        [B, N] in [0, t) in turn → their wires (``Ciphertext.to_wire``): u,
        e1 and e2 drawn ciphertext by ciphertext as encrypt draws them, the
        products transformed once for the batch."""
        p = self.params
        L, B = len(p.qs), len(ms)
        u = np.empty((B, p.n), np.int64)
        e1 = np.empty((B, p.n), np.int64)
        e2 = np.empty((B, p.n), np.int64)
        for b in range(B):
            u[b] = self._rng.integers(-1, 2, size=p.n)
            e1[b] = _sample_error(self._rng, p.n)
            e2[b] = _sample_error(self._rng, p.n)
        c0 = np.empty((B, L, p.n), np.int64)
        c1 = np.empty_like(c0)
        for i, tb in enumerate(self.tables):
            q = tb.q
            u_ntt = ntt(u, tb)
            dm = self._delta[i] * np.mod(ms.astype(np.int64), p.t) % q
            c0[:, i] = (intt(ntt(self._b_rns[i], tb) * u_ntt % q, tb)
                        + np.mod(e1, q) + dm) % q
            c1[:, i] = (intt(ntt(self._a_rns[i], tb) * u_ntt % q, tb)
                        + np.mod(e2, q)) % q
        return [{"c0": _b64_u32(c0[b]), "c1": _b64_u32(c1[b]),
                 "shape": [L, p.n], "isNtt": False} for b in range(B)]

    def query_wires(self, row_lists: List[List[int]], nbase: int, d: int
                    ) -> List[Tuple[dict, List[int]]]:
        """Copy of crypto/pir.py ``build_query_2d_multi``, called for each
        list of rows in turn: ONE ct carrying the indicators of its rows
        (row j's at j·m + i1 and j·m + G1 + i2) → [(ct wire, each row's
        offset r in its block)]."""
        p = self.params
        R = p.n // d
        _, g1, g2 = grid_dims(p.n, nbase, d)
        m = g1 + g2
        polys = np.zeros((len(row_lists), p.n), np.int64)
        offsets = []
        for b, rows in enumerate(row_lists):
            if len(rows) * m > p.n:
                raise ValueError(f"{len(rows)} rows need {len(rows) * m} "
                                 f"selector slots > N={p.n}")
            rs = []
            for j, row in enumerate(rows):
                b_star, r = divmod(int(row), R)
                i1, i2 = divmod(b_star, g2)
                polys[b, j * m + i1] = 1
                polys[b, j * m + g1 + i2] = 1
                rs.append(r)
            offsets.append(rs)
        return list(zip(self._encrypt_batch(polys), offsets))

    # -- responses (decode_response_2d) --------------------------------------
    def _decrypt_single_limb(self, c0: np.ndarray, c1: np.ndarray
                             ) -> np.ndarray:
        """crypto/pir.py ``decrypt_single_limb`` of [B, N] coefficient
        pairs mod q1: round(t·(c0 + c1·s)/q1) mod t, the product c1·s as
        one exact float64 matrix product."""
        p = self.params
        q1 = p.qs[0]
        if self._negacyclic is None:
            # (c·s)_j = Σ_{i≤j} c_i s_{j−i} − Σ_{i>j} c_i s_{N+j−i}
            n = p.n
            i = np.arange(n)[:, None]
            j = np.arange(n)[None, :]
            self._negacyclic = (self._s_signed[(j - i) % n]
                                * np.where(j >= i, 1, -1)).astype(np.float64)
        cs = np.rint(np.mod(c1, q1).astype(np.float64)
                     @ self._negacyclic).astype(np.int64)
        v = (c0 + cs) % q1
        return (v.astype(np.float64) * p.t / q1).round().astype(np.int64) % p.t

    def decode(self, resps: List[dict], d: int, rs: List[int]) -> np.ndarray:
        """Copy of crypto/pir.py ``decode_response_2d`` for a list of
        responses and their rows' offsets → the rows [len(rs), d] int64 in
        [0, t). ValueError on a response of the wrong form."""
        p = self.params
        q1, t = p.qs[0], p.t
        if len(resps) != len(rs):
            raise ValueError(f"{len(resps)} responses for {len(rs)} rows")
        nd = int(resps[0]["nDigits"]) if resps else 0
        c0, c1, inv_f = [], [], []
        for w in resps:
            g1, g2 = int(w["g1"]), int(w["g2"])
            if int(w["nDigits"]) != nd or len(w["cts"]) != 2 * nd:
                raise ValueError("a response without its 2·nDigits cts")
            logm = int(w.get("logF", max(1, (g1 + g2 - 1).bit_length())))
            inv_f.append(pow(1 << logm, -1, t))
            for ct in w["cts"]:
                c0.append(unpack_i32(ct["c0"]))
                c1.append(unpack_i32(ct["c1"]))
        B = len(resps)
        c0 = np.stack(c0).astype(np.int64).reshape(B, 2 * nd, p.n)
        c1 = np.stack(c1).astype(np.int64).reshape(B, 2 * nd, p.n)
        inv_f = np.array(inv_f, np.int64)[:, None, None]
        polys = self._decrypt_single_limb(
            c0.reshape(-1, p.n), c1.reshape(-1, p.n)).reshape(c0.shape)
        polys = polys * inv_f % t
        C = np.zeros((B, 2, p.n), np.int64)
        for which in range(2):
            for k in reversed(range(nd)):
                C[:, which] = (C[:, which] * t + polys[:, which * nd + k]) % q1
        row = self._decrypt_single_limb(C[:, 0], C[:, 1]) * inv_f[:, 0] % t
        r = np.asarray(rs, np.int64)[:, None]
        cols = r * d + np.arange(d)[None, ::-1]
        return np.take_along_axis(row, cols, axis=1)
