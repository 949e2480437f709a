"""Single-server computational PIR for the vector-retrieval stage — the
port of prefhetch_tpu/crypto/pir.py (numpy, host side).

The reference's ``/precise-vector-pir`` is PIR in name only: the client
sends indices in cleartext and the server gathers raw rows (reference:
src/server/server_lib.cpp:169-196). This module makes the retrieval
private: the server returns the requested row without learning which row
it was.

- The database [nbase, d] packs into G plaintext polynomials; block b holds
  rows [b·R, (b+1)·R), R = N/d, row j reversed inside its d-aligned window
  (the crypto/packing.py layout) — ``pack_database``.
- Naive form (``PIRClient.build_query`` → ``PIRServer.answer``): G selector
  ciphertexts a row, one response ct Σ_b ct_b ⊗ p_b.
- 1-D packed form (``build_query_packed`` → ``PIRServer.answer_packed``):
  one ct Enc(X^{b*}) expanded obliviously (``expand_query``, SealPIR-style
  Galois substitutions) into G selectors.
- 2-D hypercube form (``build_query_2d`` → ``PIR2Server.answer_2d``): the
  blocks form a G1×G2 grid; one ct carries both dimension indicators, is
  expanded breadth-first (``expand_query_batch``) to G1+G2 selectors,
  folded along dim 1, modulus-switched to one limb, base-t decomposed and
  folded along dim 2. The multi-row form (``build_query_2d_multi`` →
  ``answer_2d_multi``) packs ⌊N/(G1+G2)⌋ rows' indicators into one ct.

``PIR2Server`` is the host oracle of the device program
(engine/pir_device.py ``DevicePIR2``). The same integer seed gives the
same keys and wires as the JAX package (tests/test_torch_pir.py).

Noise: the response sums G ct×pt products with ‖p‖₁ ≤ N·255, so the
plaintext modulus stays small (t = 257 for byte-valued vectors).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from prefhetch_tpu_torch.crypto.bfv import BFVContext, Ciphertext, RelinKey
from prefhetch_tpu_torch.crypto.ntt import intt, ntt
from prefhetch_tpu_torch.crypto.params import BFVParams
from prefhetch_tpu_torch.crypto.rng import secure_rng
from prefhetch_tpu_torch.utils.wire import pack_i32, unpack_i32


def grid_dims(params: BFVParams, nbase: int, d: int) -> Tuple[int, int, int]:
    """(G, G1, G2) for the 2-D hypercube layout of a packed database."""
    R = params.n // d
    G = -(-nbase // R)
    g1 = int(np.ceil(np.sqrt(G)))
    g2 = -(-G // g1)
    return G, g1, g2


def rows_per_block(params: BFVParams, d: int) -> int:
    assert params.n % d == 0
    return params.n // d


def pack_database(base: np.ndarray, params: BFVParams) -> np.ndarray:
    """[nbase, d] byte-valued rows → packed plaintext polys [G, N]."""
    nbase, d = base.shape
    R = rows_per_block(params, d)
    G = -(-nbase // R)
    padded = np.zeros((G * R, d), np.int64)
    rounded = np.round(base).astype(np.int64)
    if not np.allclose(np.asarray(base, np.float64), rounded, atol=1e-6):
        raise ValueError(
            "PIR database rows must be integer-valued (fixed-point "
            "quantize float/cosine datasets before enabling pir_mode='he')"
        )
    if rounded.min() < 0 or rounded.max() >= params.t:
        raise ValueError(
            f"PIR database values must lie in [0, t={params.t}); "
            f"got [{rounded.min()}, {rounded.max()}] — rescale or raise "
            "pir_plain_modulus"
        )
    padded[:nbase] = rounded
    polys = np.zeros((G, params.n), np.int64)
    rev = padded[:, ::-1].reshape(G, R * d)
    polys[:, : R * d] = rev
    return polys


class PIRClient:
    """Holds the PIR keypair; builds queries and decodes responses."""

    def __init__(self, params: BFVParams, seed=None):
        import uuid

        self.params = params
        self.ctx = BFVContext(params)
        # seed=None (production): OS-entropy CSPRNG; integer seeds test-only
        self._rng = secure_rng(seed)
        self.sk, self.pk = self.ctx.keygen(self._rng)
        self.key_id = uuid.uuid4().hex

    def build_query(self, row: int, nbase: int, d: int) -> List[dict]:
        """Selector ciphertexts for one row → list of G ct wire dicts."""
        p = self.params
        R = rows_per_block(p, d)
        G = -(-nbase // R)
        b_star, r = divmod(row, R)
        s = p.n - d * (r + 1)
        polys = np.zeros((G, p.n), np.int64)
        polys[b_star, s] = 1
        cts = self.ctx.encrypt_batch(self.pk, polys, self._rng)
        return [self.ctx.to_ntt(ct).to_wire() for ct in cts]

    def decode_response(self, wire: dict, d: int) -> np.ndarray:
        """Response ct → the retrieved row [d].

        The window coefficient N−d+k carries x[d−1−k] (rows are stored
        reversed in their block windows), so the read is flipped."""
        ct = Ciphertext.from_wire(wire)
        coeffs = self.ctx.decrypt(self.sk, ct)
        return coeffs[self.params.n - d :][::-1].astype(np.float32)

    # -- packed (oblivious-expansion) variant ---------------------------
    def build_query_packed(self, row: int, nbase: int, d: int) -> Tuple[dict, int]:
        """One ciphertext Enc(X^{b*}) selecting the block; returns
        (ct wire, row-within-block r for local decode)."""
        p = self.params
        R = rows_per_block(p, d)
        b_star, r = divmod(row, R)
        poly = np.zeros(p.n, np.int64)
        poly[b_star] = 1
        ct = self.ctx.encrypt(self.pk, poly, self._rng)
        return ct.to_wire(), r

    def galois_keys_wire(self, nbase: int, d: int) -> dict:
        """Public expansion keys (one-time registration)."""
        p = self.params
        R = rows_per_block(p, d)
        G = -(-nbase // R)
        elts = expansion_galois_elements(p.n, G)
        if not hasattr(self, "_gks"):
            self._gks = {}
        missing = [g for g in elts if g not in self._gks]
        if missing:
            self._gks.update(
                self.ctx.galois_keygen(self.sk, missing, self._rng)
            )
        return {str(g): self._gks[g].to_wire() for g in elts}

    # -- 2-D (hypercube) variant -----------------------------------------
    def build_query_2d(self, row: int, nbase: int, d: int) -> Tuple[dict, int]:
        """One ct carrying BOTH dimension indicators: coefficient i1 and
        coefficient G1+i2 are 1. Returns (ct wire, row-within-block r)."""
        p = self.params
        R = rows_per_block(p, d)
        _, g1, g2 = grid_dims(p, nbase, d)
        b_star, r = divmod(row, R)
        # grid layout is row-major [g1, g2]: block b ↔ (i1, i2) = (b//g2, b%g2)
        i1, i2 = divmod(b_star, g2)
        assert g1 + g2 <= p.n, "hypercube dims exceed ring degree"
        poly = np.zeros(p.n, np.int64)
        poly[i1] = 1
        poly[g1 + i2] = 1           # always distinct: g1+i2 ≥ g1 > i1
        ct = self.ctx.encrypt(self.pk, poly, self._rng)
        return ct.to_wire(), r

    # -- multi-row packed 2-D variant --------------------------------------
    def rows_per_ct(self, nbase: int, d: int) -> int:
        """How many row-fetches one query ct can carry: each row needs its
        own m = G1+G2 selector coefficients, so K = ⌊N/m⌋ (≥1)."""
        p = self.params
        _, g1, g2 = grid_dims(p, nbase, d)
        return max(1, p.n // (g1 + g2))

    def build_query_2d_multi(
        self, rows: List[int], nbase: int, d: int
    ) -> Tuple[dict, List[int]]:
        """ONE ct carrying the 2-D indicators of SEVERAL rows: row j's
        (i1, i2) pair lands at coefficients j·m + i1 and j·m + G1 + i2.
        Oblivious expansion to len(rows)·m selectors recovers every row's
        selector block (crypto/pir.expand_query docstring) — the upload
        shrinks ~K× vs one ct per row (K = rows_per_ct; ~11 at nbase=1M).

        Returns (ct wire, per-row r offsets). len(rows)·m must fit in N."""
        p = self.params
        R = rows_per_block(p, d)
        _, g1, g2 = grid_dims(p, nbase, d)
        m = g1 + g2
        if len(rows) * m > p.n:
            raise ValueError(
                f"{len(rows)} rows need {len(rows) * m} selector slots "
                f"> N={p.n}; chunk to rows_per_ct={p.n // m}"
            )
        poly = np.zeros(p.n, np.int64)
        rs = []
        for j, row in enumerate(rows):
            b_star, r = divmod(row, R)
            i1, i2 = divmod(b_star, g2)
            poly[j * m + i1] = 1
            poly[j * m + g1 + i2] = 1
            rs.append(r)
        ct = self.ctx.encrypt(self.pk, poly, self._rng)
        return ct.to_wire(), rs

    def galois_keys_wire_2d_multi(
        self, nbase: int, d: int, n_rows: int
    ) -> dict:
        """Expansion keys for n_rows·m selectors (deeper tree than the
        single-row keys; per-element cache shared with galois_keys_wire_2d)."""
        p = self.params
        _, g1, g2 = grid_dims(p, nbase, d)
        elts = expansion_galois_elements(p.n, n_rows * (g1 + g2))
        if not hasattr(self, "_gks"):
            self._gks = {}
        missing = [g for g in elts if g not in self._gks]
        if missing:
            self._gks.update(
                self.ctx.galois_keygen(self.sk, missing, self._rng)
            )
        return {str(g): self._gks[g].to_wire() for g in elts}

    def galois_keys_wire_2d(self, nbase: int, d: int) -> dict:
        """Expansion keys for m = G1+G2 selectors (one-time registration)."""
        p = self.params
        _, g1, g2 = grid_dims(p, nbase, d)
        elts = expansion_galois_elements(p.n, g1 + g2)
        if not hasattr(self, "_gks"):
            self._gks = {}
        missing = [g for g in elts if g not in self._gks]
        if missing:
            self._gks.update(
                self.ctx.galois_keygen(self.sk, missing, self._rng)
            )
        return {str(g): self._gks[g].to_wire() for g in elts}

    def decode_response_2d(self, resp: dict, d: int, r: int) -> np.ndarray:
        """2-D response → the retrieved row [d].

        Two-stage decode: (1) decrypt the digit cts (each single-limb),
        un-scale by F⁻¹ mod t, recombine base-t digits into the column
        ciphertext C = (c0, c1) mod q1; (2) decrypt C (single-limb),
        un-scale by F⁻¹ again, read row r's reversed window."""
        p = self.params
        q1 = p.qs[0]
        t = p.t
        nd = int(resp["nDigits"])
        g1, g2 = int(resp["g1"]), int(resp["g2"])
        # multi-row packed queries expand deeper than g1+g2 selectors; the
        # response then carries the actual expansion scale as logF
        logm = int(resp.get("logF", max(1, (g1 + g2 - 1).bit_length())))
        inv_f = pow(1 << logm, -1, t)
        polys = []
        for w in resp["cts"]:
            c0 = unpack_i32(w["c0"]).astype(np.int64)
            c1 = unpack_i32(w["c1"]).astype(np.int64)
            m = decrypt_single_limb(self.ctx, self.sk, c0, c1)
            polys.append(m * inv_f % t)
        C = np.zeros((2, p.n), np.int64)
        for which in range(2):
            for k in reversed(range(nd)):
                C[which] = (C[which] * t + polys[which * nd + k]) % q1
        row_poly = decrypt_single_limb(self.ctx, self.sk, C[0], C[1])
        row_poly = row_poly * inv_f % t
        return row_poly[r * d : (r + 1) * d][::-1].astype(np.float32)

    def decode_block_response(
        self, wire: dict, d: int, r: int, n_blocks: int
    ) -> np.ndarray:
        """Packed response ct → the retrieved row [d].

        The response encrypts 2^⌈log₂G⌉·p_{b*}; undo the expansion scale
        with its inverse mod t, then read row r's reversed window."""
        p = self.params
        ct = Ciphertext.from_wire(wire)
        coeffs = self.ctx.decrypt(self.sk, ct)
        logm = max(1, (n_blocks - 1).bit_length())
        inv = pow(1 << logm, -1, p.t)
        coeffs = (coeffs * inv) % p.t
        return coeffs[r * d : (r + 1) * d][::-1].astype(np.float32)


def expand_query(
    ctx: BFVContext, ct: Ciphertext, m: int, gks: dict
) -> List[Ciphertext]:
    """SealPIR-style oblivious expansion: one ct encrypting Σ_b a_b·X^b →
    m ciphertexts, the b-th encrypting 2^⌈log₂m⌉ · a_b.

    Each of ⌈log₂ m⌉ rounds substitutes X → X^{N/2^j + 1} (Galois key
    switch) to split even/odd coefficient trees. Round j splits on bit j of
    the coefficient index but prepends the choice to the output index, so
    coefficient b emerges at the bit-reversed position — undone here so
    the returned list is in natural coefficient order. The 2^logm scale
    factor is undone at decode with its inverse mod t (t must be odd)."""
    n = ctx.params.n
    logm = max(1, (m - 1).bit_length())
    cts = [ct]
    for j in range(logm):
        g = (n >> j) + 1
        gk = gks[g]
        new = []
        for c in cts:
            c_g = ctx.apply_galois(c, g, gk)
            even = ctx.add(c, c_g)
            c_sh = ctx.mul_monomial(c, -(1 << j))
            c_sh_g = ctx.apply_galois(c_sh, g, gk)
            odd = ctx.add(c_sh, c_sh_g)
            new += [even, odd]
        cts = new

    def bitrev(x: int) -> int:
        r = 0
        for _ in range(logm):
            r = (r << 1) | (x & 1)
            x >>= 1
        return r

    return [cts[bitrev(b)] for b in range(m)]


def expand_query_batch(
    ctx: BFVContext, ct: Ciphertext, m: int, gks: dict
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched expand_query: returns (c0s [m, L, N], c1s [m, L, N]).

    Identical math to expand_query, but each doubling round runs ONE
    batched automorphism + key switch over all current ciphertexts
    (bfv.apply_galois_batch) instead of a per-ct Python loop — the
    expansion is ~10× faster at G in the hundreds and is the shape the
    device path consumes."""
    p = ctx.params
    n = p.n
    ct = ctx.from_ntt(ct) if ct.is_ntt else ct
    logm = max(1, (m - 1).bit_length())
    qs = np.array(p.qs, np.int64)[None, :, None]
    c0s = ct.c0[None].copy()                       # [1, L, N]
    c1s = ct.c1[None].copy()
    k = np.arange(n)
    for j in range(logm):
        g = (n >> j) + 1
        gk = gks[g]
        # monomial shift by −2^j (signed negacyclic rotation), batched
        e = (-(1 << j)) % (2 * n)
        dest = (k + e) % (2 * n)
        sign = np.where(dest < n, 1, -1).astype(np.int64)
        pos = dest % n
        sh0 = np.zeros_like(c0s)
        sh1 = np.zeros_like(c1s)
        sh0[:, :, pos] = c0s * sign[None, None, :]
        sh1[:, :, pos] = c1s * sign[None, None, :]
        sh0 %= qs
        sh1 %= qs
        both0 = np.concatenate([c0s, sh0])          # [2M, L, N]
        both1 = np.concatenate([c1s, sh1])
        g0, g1 = ctx.apply_galois_batch(both0, both1, g, gk)
        c0s = np.mod(both0 + g0, qs)
        c1s = np.mod(both1 + g1, qs)
    # breadth-first [all-even ‖ all-odd] concatenation puts round-j's
    # choice at position bit j — which is exactly coefficient order, so
    # (unlike depth-first expand_query) no bit-reversal is needed
    return c0s[:m], c1s[:m]


def expansion_galois_elements(n: int, m: int) -> List[int]:
    """Galois elements needed by expand_query for m selectors."""
    logm = max(1, (m - 1).bit_length())
    return [(n >> j) + 1 for j in range(logm)]


def mod_switch_to_first(
    params: BFVParams, c0: np.ndarray, c1: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """BFV modulus switch q=q1·q2 → q1 on coeff-domain ct arrays
    [..., L, N] → [..., N]: c' = (c − [c]_{q2,centered})·q2⁻¹ mod q1.
    Divides the noise by q2 (+ small rounding) — the response-size lever:
    one limb crosses the wire instead of L."""
    assert len(params.qs) == 2, "mod_switch_to_first expects 2 limbs"
    q1, q2 = params.qs
    inv_q2 = pow(q2, -1, q1)

    def down(c):
        r2 = c[..., 1, :]
        r2c = np.where(r2 > q2 // 2, r2 - q2, r2)        # centered mod q2
        return (c[..., 0, :] - r2c) % q1 * inv_q2 % q1

    return down(c0), down(c1)


def decrypt_single_limb(
    ctx: BFVContext, sk, c0: np.ndarray, c1: np.ndarray
) -> np.ndarray:
    """Decrypt a mod-switched (single-limb) ct: round(t·(c0+c1·s)/q1) mod t."""
    p = ctx.params
    tb = ctx.tables[0]
    q1 = p.qs[0]
    cs = intt(ntt(c1 % q1, tb) * ntt(sk.s_rns[0], tb) % q1, tb)
    v = (c0 + cs) % q1
    return (
        (v.astype(np.float64) * p.t / q1).round().astype(np.int64) % p.t
    )


class PIR2Server:
    """SealPIR-style 2-D PIR: the database packs into a G1×G2 hypercube of
    plaintext polys; ONE uploaded ciphertext expands obliviously into
    G1+G2 selectors; dim-1 folds the cube to G2 column ciphertexts; their
    coefficients are base-t decomposed into plaintexts and folded again by
    dim-2. Upload O(1) ct; response 2·L·⌈30/log₂t⌉ single-limb cts; server
    work O(G) MACs + O(√G) expansion key-switches — vs the 1-D scheme's
    O(G) host key-switches that made 1M-row fetches unusable
    (upgrades reference: src/server/server_lib.cpp:169-196 at full scale).

    The server holds NO secret material (expansion keys are public)."""

    def __init__(self, base: np.ndarray, params: BFVParams):
        self.params = params
        self.ctx = BFVContext(params)
        self.d = base.shape[1]
        self.nbase = base.shape[0]
        polys = pack_database(base, params)              # [G, N]
        G = polys.shape[0]
        self.g1 = int(np.ceil(np.sqrt(G)))
        self.g2 = -(-G // self.g1)
        padded = np.zeros((self.g1 * self.g2, params.n), np.int64)
        padded[:G] = polys
        # dim-1 operand in NTT domain: [G1, G2, L, N]
        self.db_ntt = np.stack(
            [self.ctx.plain_to_ntt(p_) for p_ in padded]
        ).reshape(self.g1, self.g2, len(params.qs), params.n)
        self._galois: dict = {}
        self._n_digits = 1
        while (params.t ** self._n_digits) < params.qs[0]:
            self._n_digits += 1

    @property
    def n_selectors(self) -> int:
        return self.g1 + self.g2

    def rows_per_ct(self) -> int:
        """Max row-fetches one packed query ct carries (⌊N/m⌋)."""
        return max(1, self.params.n // self.n_selectors)

    def register_galois_keys(self, key_id: str, gks_wire: dict) -> None:
        self._galois[key_id] = {
            int(g): RelinKey.from_wire(w) for g, w in gks_wire.items()
        }

    def has_keys(self, key_id: str) -> bool:
        return key_id in self._galois

    def answer_2d(self, query_wire: dict, key_id: str) -> dict:
        """ONE query ct → the 2·L·n_digits single-limb response cts."""
        gks = self._galois[key_id]
        ct = Ciphertext.from_wire(query_wire)
        sel0, sel1 = expand_query_batch(
            self.ctx, ct, self.n_selectors, gks
        )                                                # [m, L, N] coeff
        logf = max(1, (self.n_selectors - 1).bit_length())
        return self._fold_2d(sel0, sel1, logf)

    def answer_2d_multi(
        self, query_wire: dict, key_id: str, n_rows: int
    ) -> List[dict]:
        """ONE multi-row packed ct (build_query_2d_multi) → n_rows
        responses. Expansion runs ONCE to n_rows·m selectors; each row's
        m-selector block folds independently."""
        m = self.n_selectors
        if n_rows < 1 or n_rows * m > self.params.n:
            raise ValueError(f"bad n_rows={n_rows} for m={m}")
        gks = self._galois[key_id]
        ct = Ciphertext.from_wire(query_wire)
        sel0, sel1 = expand_query_batch(self.ctx, ct, n_rows * m, gks)
        logf = max(1, (n_rows * m - 1).bit_length())
        return [
            self._fold_2d(
                sel0[j * m : (j + 1) * m], sel1[j * m : (j + 1) * m], logf
            )
            for j in range(n_rows)
        ]

    def _fold_2d(self, sel0: np.ndarray, sel1: np.ndarray,
                 logf: int) -> dict:
        """dim-1 + dim-2 hypercube folds for ONE row's [m, L, N] selector
        block (coeff domain); logf = expansion depth for client decode."""
        p = self.params
        sel0_ntt = self.ctx.ntt_fwd_batch(sel0)
        sel1_ntt = self.ctx.ntt_fwd_batch(sel1)
        qs = np.array(p.qs, np.int64)[:, None]

        # dim 1: fold rows — C_j = Σ_i sel_i ⊗ p_{i,j}   [G2, L, N] each.
        # Products are < 2^60; at most 8 may accumulate in int64 before a
        # modular reduction, hence the chunked sum.
        s0 = sel0_ntt[: self.g1]
        s1 = sel1_ntt[: self.g1]
        C0 = np.zeros((self.g2, len(p.qs), p.n), np.int64)
        C1 = np.zeros_like(C0)
        CH = 4
        for i in range(0, self.g1, CH):                 # bounded: √G terms
            sl = slice(i, min(i + CH, self.g1))
            C0 = (C0 + (s0[sl, None] * self.db_ntt[sl]).sum(0)) % qs
            C1 = (C1 + (s1[sl, None] * self.db_ntt[sl]).sum(0)) % qs
        C0 = self.ctx.intt_batch(C0)
        C1 = self.ctx.intt_batch(C1)

        # mod-switch columns to q1, then base-t digit decomposition
        c0d, c1d = mod_switch_to_first(p, C0, C1)        # [G2, N] each
        t = p.t
        nd = self._n_digits
        digs = np.empty((2, nd, self.g2, p.n), np.int64)
        for which, poly in enumerate((c0d, c1d)):
            x = poly.copy()
            for k in range(nd):
                digs[which, k] = x % t
                x //= t

        # dim 2: fold columns with the second selector block (NTT the
        # digit plaintexts once per (which, k))
        w0 = sel0_ntt[self.g1 : self.g1 + self.g2]       # [G2, L, N]
        w1 = sel1_ntt[self.g1 : self.g1 + self.g2]
        out = []
        CH = 4
        for which in range(2):
            for k in range(nd):
                flat = digs[which, k]                    # [G2, N] small
                pt_ntt = np.empty((self.g2, len(p.qs), p.n), np.int64)
                for li, tb in enumerate(self.ctx.tables):
                    pt_ntt[:, li] = ntt(flat % tb.q, tb)
                r0 = np.zeros((len(p.qs), p.n), np.int64)
                r1 = np.zeros_like(r0)
                for j in range(0, self.g2, CH):
                    sl = slice(j, min(j + CH, self.g2))
                    r0 = (r0 + (w0[sl] * pt_ntt[sl]).sum(0)) % qs
                    r1 = (r1 + (w1[sl] * pt_ntt[sl]).sum(0)) % qs
                r0 = self.ctx.intt_batch(r0[None])[0]
                r1 = self.ctx.intt_batch(r1[None])[0]
                o0, o1 = mod_switch_to_first(p, r0, r1)  # [N] each
                out.append((o0, o1))
        return {
            "cts": [
                {"c0": pack_i32(o0.astype(np.int32)),
                 "c1": pack_i32(o1.astype(np.int32))}
                for o0, o1 in out
            ],
            "nDigits": nd,
            "g1": self.g1,
            "g2": self.g2,
            "logF": logf,
        }


class PIRServer:
    """Precomputes NTT(p_b) for the packed database; answers queries with
    Σ_b ct_b ⊗ p_b. Holds no keys; never sees the requested index."""

    def __init__(self, base: np.ndarray, params: BFVParams):
        self.params = params
        self.ctx = BFVContext(params)
        self.d = base.shape[1]
        self.nbase = base.shape[0]
        polys = pack_database(base, params)
        self.db_ntt = np.stack(
            [self.ctx.plain_to_ntt(p) for p in polys]
        )                                     # [G, L, N]

    @property
    def n_blocks(self) -> int:
        return self.db_ntt.shape[0]

    def register_galois_keys(self, key_id: str, gks_wire: dict) -> None:
        if not hasattr(self, "_galois"):
            self._galois = {}
        self._galois[key_id] = {
            int(g): RelinKey.from_wire(w) for g, w in gks_wire.items()
        }

    def has_keys(self, key_id: str) -> bool:
        return hasattr(self, "_galois") and key_id in self._galois

    def answer_packed(self, query_wire: dict, key_id: str) -> dict:
        """Oblivious-expansion path: ONE uploaded ct → ONE response ct."""
        gks = self._galois[key_id]
        ct = Ciphertext.from_wire(query_wire)
        selectors = expand_query(self.ctx, ct, self.n_blocks, gks)
        p = self.params
        qs = np.array(p.qs, np.int64)[:, None]
        acc0 = np.zeros((len(p.qs), p.n), np.int64)
        acc1 = np.zeros_like(acc0)
        for b, sel in enumerate(selectors):
            sel = self.ctx.to_ntt(sel)
            acc0 = (acc0 + sel.c0 * self.db_ntt[b]) % qs
            acc1 = (acc1 + sel.c1 * self.db_ntt[b]) % qs
        return Ciphertext(c0=acc0, c1=acc1, is_ntt=True).to_wire()

    def answer(self, query_wires: List[dict]) -> dict:
        p = self.params
        G = self.db_ntt.shape[0]
        if len(query_wires) != G:
            raise ValueError(
                f"PIR query must carry {G} ciphertexts, got {len(query_wires)}"
            )
        qs = np.array(p.qs, np.int64)[:, None]
        acc0 = np.zeros((len(p.qs), p.n), np.int64)
        acc1 = np.zeros_like(acc0)
        for b, w in enumerate(query_wires):
            ct = Ciphertext.from_wire(w)
            if not ct.is_ntt:
                # untrusted wire input: convert rather than assume
                ct = self.ctx.to_ntt(ct)
            acc0 = (acc0 + ct.c0 * self.db_ntt[b]) % qs
            acc1 = (acc1 + ct.c1 * self.db_ntt[b]) % qs
        return Ciphertext(c0=acc0, c1=acc1, is_ntt=True).to_wire()
