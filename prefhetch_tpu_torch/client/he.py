"""Client-side homomorphic encryption: keygen, query encryption, score
decryption — the port of prefhetch_tpu/client/he.py (host, numpy only).

All key material lives here; the server never sees any secret (for the
packed and the CKKS responses the client registers *public* Galois keys
once). Schemes:

- "bfv"  — exact integer inner products via negacyclic coefficient packing
           (crypto/packing.py); no evaluation keys for the "full" and "q1"
           response wires, extraction keys for "packed";
- "ckks" — approximate slot-packed scoring (BASELINE config 3): the query
           is replicated across the slots, the server rotate-accumulates
           with the registered Galois keys; per-block or "combined"
           responses.

The same integer seed gives the same keys and the same wires as the JAX
package's ``HEClient`` (tests/test_torch_bfv.py, tests/test_torch_packed.py,
tests/test_torch_ckks_route.py).
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional

import numpy as np

from prefhetch_tpu_torch.crypto import ckks
from prefhetch_tpu_torch.crypto.bfv import BFVContext, Ciphertext, RelinKey
from prefhetch_tpu_torch.crypto.ntt import intt, ntt
from prefhetch_tpu_torch.crypto.packing import (
    distances_from_inner_products,
    encode_query_poly,
)
from prefhetch_tpu_torch.crypto.params import bfv_params_for, ckks_params_for
from prefhetch_tpu_torch.crypto.rng import secure_rng
from prefhetch_tpu_torch.utils.config import HEParams


class HEClient:
    """Holds the client's HE keys and drives encrypt/decrypt."""

    def __init__(self, he: HEParams, seed: Optional[int] = None):
        self.he = he
        self.scheme = he.scheme
        if he.scheme not in ("bfv", "ckks"):
            raise NotImplementedError(f"scheme {he.scheme}")
        # seed=None (production): OS-entropy CSPRNG. Integer seeds are for
        # tests only — deterministic secret keys are publicly derivable.
        self._rng = secure_rng(seed)
        self.key_id = uuid.uuid4().hex
        self._keys_sent = False
        if he.scheme == "bfv":
            # packed response mode needs ODD t (the ×d extraction factor
            # must invert mod t — crypto/params.bfv_params_for)
            self.params = bfv_params_for(he.n, he.t_bits, he.n_limbs,
                                         odd_t=he.resp_mod == "packed")
            self.ctx = BFVContext(self.params)
            self.sk, self.pk = self.ctx.keygen(self._rng,
                                               sparse_h=he.sparse_h)
            self._galois_bfv: Dict[int, RelinKey] = {}
        else:
            self.params = ckks_params_for(he.n, he.scale_bits, he.n_limbs)
            self.ctx = ckks.CKKSContext(self.params)
            self.sk, self.pk = self.ctx.keygen(self._rng)
            self._galois: Dict[int, ckks.GaloisKey] = {}

    # -- galois keys (ckks) ------------------------------------------------
    def combine_blocks(self, p: int, d: int) -> int:
        """Blocks the combined single-ct response will tree-merge for P
        candidates of dimension d (pow2, matches the server's padding)."""
        return ckks.combined_blocks_padded(p, self.params.n // 2, d)

    def galois_keys_wire(
        self, d: int, combine_blocks: int = 1
    ) -> Optional[dict]:
        """Public rotation keys for block size d (generated once, sent once:
        None after the first call, and None under BFV). With
        combine_blocks > 1 also the −W·2^k combine-tree steps the combined
        single-ct response needs (resp_mod="combined")."""
        if self.scheme != "ckks" or self._keys_sent:
            return None
        steps = ckks.rotation_steps(d)
        if combine_blocks > 1:
            steps = steps + self.ctx.combine_tree_steps(combine_blocks, d)
        missing = [s for s in steps if s not in self._galois]
        if missing:
            self._galois.update(
                self.ctx.galois_keygen(self.sk, missing, self._rng)
            )
        self._keys_sent = True
        return {str(s): self._galois[s].to_wire() for s in steps}

    # -- galois keys (packed response) ------------------------------------
    def bfv_extraction_keys_wire(self, d: int) -> Optional[dict]:
        """Public Galois keys for the packed single-ct BFV response
        (resp_mod="packed"): the log2(d) coefficient-extraction elements
        (crypto/bfv.BFVContext.extraction_elts). Generated once and sent
        once: None after the first call, and None under CKKS."""
        if self.scheme != "bfv" or self._keys_sent:
            return None
        elts = self.ctx.extraction_elts(self.params.n, d)
        missing = [g for g in elts if g not in self._galois_bfv]
        if missing:
            # 30-bit digits: one digit per RNS limb — half the server's
            # per-round digit-NTT rows and half the key wire; the extra
            # key-switch noise stays orders below the packed wire's Δ/2
            # budget (RelinKey.digit_bits, exactness asserted in tests)
            self._galois_bfv.update(
                self.ctx.galois_keygen(
                    self.sk, missing, self._rng, digit_bits=30
                )
            )
        self._keys_sent = True
        return {str(g): self._galois_bfv[g].to_wire() for g in elts}

    # -- encrypt ----------------------------------------------------------
    def encrypt_query_batch(self, queries: np.ndarray) -> List[dict]:
        """Encrypt a [nq, d] query batch. BFV: seeded SYMMETRIC ciphertexts
        (the client holds the secret key, so c1 travels as a seed — half
        the upload): a 32-byte SHAKE seed (crypto/bfv.py
        encrypt_symmetric_batch_ntt), or under resp_mod="packed" an 8-byte
        threefry key that the server expands inside its device program
        (encrypt_symmetric_batch_ntt_tf, with its PRG note). CKKS: one
        ``encrypt_query`` a query."""
        if self.scheme != "bfv":
            return [self.encrypt_query(q) for q in queries]
        ms = np.stack([encode_query_poly(q, self.params) for q in queries])
        if self.he.resp_mod == "packed":
            wires = self.ctx.encrypt_symmetric_batch_ntt_tf(
                self.sk, ms, self._rng)
        else:
            wires = self.ctx.encrypt_symmetric_batch_ntt(
                self.sk, ms, self._rng)
        for w in wires:
            w["scheme"] = self.scheme
        return wires

    def encrypt_query(self, q: np.ndarray) -> dict:
        """Query vector [d] → ciphertext wire dict (scheme-tagged). BFV: a
        public-key ciphertext; CKKS: the rounded query replicated across
        the N/2 slots, threefry-seeded symmetric (c0 and an 8-byte key)
        under resp_mod="combined", public-key otherwise."""
        if self.scheme == "bfv":
            poly = encode_query_poly(q, self.params)
            ct = self.ctx.to_ntt(self.ctx.encrypt(self.pk, poly, self._rng))
            w = ct.to_wire()
        else:
            d = q.shape[0]
            slots = self.params.n // 2
            tiled = np.tile(np.round(q).astype(np.float64), slots // d)
            coeffs = self.ctx.encode(tiled)
            if self.he.resp_mod == "combined":
                w = self.ctx.encrypt_symmetric_tf(self.sk, coeffs, self._rng)
            else:
                w = self.ctx.encrypt(self.pk, coeffs, self._rng).to_wire()
        w["scheme"] = self.scheme
        return w

    # -- decrypt ----------------------------------------------------------
    def _distances(self, ips, norms, queries) -> np.ndarray:
        """Centred inner products [nq, nb·B] → exact distances [nq, P]."""
        nq, P = norms.shape
        t = self.params.t
        ips = np.where(ips > t // 2, ips - t, ips)[:, :P]
        out = np.empty((nq, P), np.float32)
        for i in range(nq):
            out[i] = distances_from_inner_products(
                queries[i], ips[i], np.asarray(norms[i])
            )
        return out

    def decrypt_scores_trunc(
        self,
        c1_ntt: np.ndarray,    # [nq, nb, L, N] int32 — response c1, NTT dom.
        c0_ip: np.ndarray,     # [nq, nb, L, B] int32 — c0 at ip coefficients
        norms: np.ndarray,     # [nq, P]
        queries: np.ndarray,   # [nq, d]
    ) -> np.ndarray:
        """Decrypt the truncated-response wire (engine/hecompute.py
        encrypted_scores_trunc) → exact distances [nq, P].

        Per limb: ONE batched pointwise c1⊙NTT(s) + ONE batched inverse NTT
        over all (query, block) pairs, then the CRT float64 fraction
        rounding of crypto/bfv.py restricted to the B ip coefficients."""
        p = self.params
        nq = norms.shape[0]
        d = queries.shape[1]
        B = p.n // d
        nb = c1_ntt.shape[1]
        q, t = p.q, p.t
        pos = np.arange(B) * d + (d - 1)
        frac = np.zeros((nq, nb, B), np.float64)
        for i, tb in enumerate(self.ctx.tables):
            qi = tb.q
            s_ntt = ntt(self.sk.s_rns[i], tb)                  # [N]
            w = c1_ntt[:, :, i].astype(np.int64).reshape(-1, p.n)
            cs = intt(w * s_ntt % qi, tb)[:, pos]              # [nq·nb, B]
            v = (cs.reshape(nq, nb, B) + c0_ip[:, :, i]) % qi
            inv = pow((q // qi) % qi, -1, qi)
            frac += ((v * inv) % qi).astype(np.float64) / qi
        frac -= np.floor(frac)
        ips = np.round(t * frac).astype(np.int64) % t
        return self._distances(ips.reshape(nq, nb * B), norms, queries)

    def decrypt_scores_trunc_q1(
        self,
        c1_q1: np.ndarray,     # [nq, nb, N] int32 — response c1 mod q1,
                               # COEFFICIENT domain (see hecompute *_q1)
        c0_ip: np.ndarray,     # [nq, nb, B] int32 — c0 ip coeffs mod q1
        norms: np.ndarray,     # [nq, P]
        queries: np.ndarray,   # [nq, d]
    ) -> np.ndarray:
        """Decrypt the modulus-switched single-limb wire → exact distances.

        Needs a sparse secret (HEParams.sparse_h ≤ 48): the server's
        mod-down left rounding error ≤ (1+h)/2 which must stay under
        q1/(2t) — see engine/hecompute._trunc_mac_q1's budget."""
        p = self.params
        nq = norms.shape[0]
        d = queries.shape[1]
        B = p.n // d
        nb = c1_q1.shape[1]
        tb = self.ctx.tables[0]
        q1, t = tb.q, p.t
        pos = np.arange(B) * d + (d - 1)
        s_ntt = ntt(self.sk.s_rns[0], tb)
        w = ntt(
            np.mod(c1_q1.astype(np.int64).reshape(-1, p.n), q1), tb
        )
        cs = intt(w * s_ntt % q1, tb)[:, pos].reshape(nq, nb, B)
        v = (cs + c0_ip) % q1
        ips = np.round(t * (v.astype(np.float64) / q1)).astype(np.int64) % t
        return self._distances(ips.reshape(nq, nb * B), norms, queries)

    def decrypt_scores_packed(
        self,
        packed_wires: List[dict],      # [ceil(nq/G)] coeff-domain ct wires
        norms: np.ndarray,             # [nq, P]
        queries: np.ndarray,           # [nq, d]
        pack_group: int,               # G = queries per response ct
    ) -> np.ndarray:
        """Decrypt the packed single-ct response
        (engine/hecompute.py encrypted_scores_packed: query qi × candidate
        b·B + j at coefficient j·d + (qi mod G)·nb + b of ct qi//G, scaled
        by d) → exact squared-L2 distances [nq, P]."""
        p = self.params
        nq, P = norms.shape
        d = queries.shape[1]
        B = p.n // d
        nb = -(-P // B)
        G = pack_group
        inv_d = pow(d % p.t, -1, p.t)
        msgs = self.ctx.decrypt_batch(
            self.sk,
            [w if isinstance(w, Ciphertext) else Ciphertext.from_wire(w)
             for w in packed_wires],
        )                                              # [n_out, N] mod t
        # coefficient of (qi, b, j): j·d + (qi mod G)·nb + b of ct qi // G
        qi = np.arange(nq)[:, None, None]
        b = np.arange(nb)[None, :, None]
        j = np.arange(B)[None, None, :]
        ips = msgs[qi // G, j * d + (qi % G) * nb + b]  # [nq, nb, B]
        ips = ips.reshape(nq, nb * B) * inv_d % p.t      # undo ×d extraction
        return self._distances(ips, norms, queries)

    def decrypt_scores_combined(
        self,
        ct_wires: List[dict],           # [nq] ONE level-1 ct per query
        norms: np.ndarray,              # [nq, P]
        queries: np.ndarray,            # [nq, d]
    ) -> np.ndarray:
        """Decrypt the combined single-ct CKKS response
        (CKKSComputeService.encrypted_scores_combined: ⟨q, x_{b·per_ct+j}⟩
        at slot j·d + W·b) → approximate squared-L2 distances [nq, P]."""
        assert self.scheme == "ckks"
        nq, P = norms.shape
        d = queries.shape[1]
        out = np.empty((nq, P), np.float32)
        for i in range(nq):
            vals = self.ctx.decrypt(
                self.sk, ckks.CKKSCiphertext.from_wire(ct_wires[i]))
            ips = ckks.extract_combined_ips(vals, P, d)
            out[i] = distances_from_inner_products(
                queries[i], ips, np.asarray(norms[i]))
        return out

    def decrypt_scores_batch(
        self,
        score_ct_wires_per_query: List[List[dict]],   # [nq][n_blocks]
        norms: np.ndarray,                            # [nq, P]
        queries: np.ndarray,                          # [nq, d]
    ) -> np.ndarray:
        """Decrypt every query's per-block result ciphertexts → squared-L2
        distances [nq, P]: BFV exactly, in one batched decryption over all
        queries' blocks (HEComputeService.encrypted_scores_batch); CKKS
        approximately, one query at a time."""
        if self.scheme != "bfv":
            return np.stack([
                self.decrypt_scores(w, norms[i], queries[i])
                for i, w in enumerate(score_ct_wires_per_query)])
        nq = len(score_ct_wires_per_query)
        d = queries.shape[1]
        cts = [Ciphertext.from_wire(w)
               for per_q in score_ct_wires_per_query for w in per_q]
        prods = self.ctx.decrypt_batch(self.sk, cts)      # [nq·nb, N]
        # candidate j of a block at coefficient j·d + d − 1
        ips = prods[:, d - 1::d].reshape(nq, -1)
        return self._distances(ips, np.asarray(norms), queries)

    def decrypt_scores(
        self,
        score_ct_wires: List[dict],     # per-block result ciphertexts
        norms: np.ndarray,              # [P] candidate squared norms
        q: np.ndarray,                  # [d] the plaintext query (local)
    ) -> np.ndarray:
        """Decrypt one query's Enc(⟨q,x⟩) blocks → squared-L2 distances
        [P]: BFV exactly (``decrypt_scores_batch`` of one query); CKKS
        approximately (slot j·d of block b holds candidate b·per_ct + j)."""
        if self.scheme == "bfv":
            return self.decrypt_scores_batch(
                [score_ct_wires], np.asarray(norms)[None], q[None])[0]
        d = q.shape[0]
        P = norms.shape[0]
        per_ct = (self.params.n // 2) // d
        vals = []
        for w in score_ct_wires:
            ct = ckks.CKKSCiphertext.from_wire(w)
            out = np.real(self.ctx.decrypt(self.sk, ct))
            vals.append(out[np.arange(per_ct) * d])
        ips = np.concatenate(vals)[:P]
        return distances_from_inner_products(
            q, ips, np.asarray(norms)).astype(np.float32)
