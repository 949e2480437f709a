"""Server-side homomorphic compute: batched encrypted-distance MACs on the
card — the port of prefhetch_tpu/engine/hecompute.py, BFV subset.

The server receives an encrypted query (BFV ciphertext, NTT domain), packs
the client-named candidate vectors into plaintext polynomials
(crypto/packing.py's layout), forward-NTTs them on the device, and performs
one pointwise ciphertext×plaintext modular multiply per candidate block and
limb. The server holds NO keys — ct×pt needs none, so the privacy contract
is unconditional on the server side.

Ported: the two response wires that need only ct×pt arithmetic,
``encrypted_scores_trunc`` ("full") and ``encrypted_scores_trunc_q1``
("q1"), each one gather, one forward four-step NTT, pointwise modmuls and
inverse NTTs; and the packed single-ct response
(``encrypted_scores_packed``, ``encrypted_scores_packed_wire``), which
coefficient-extracts the inner products with client-registered Galois keys
(log2(d) automorphism + key-switch rounds) and sums d/nb queries' blocks
into one 2-limb ciphertext; its threefry-seeded wire has the c1 mask
regenerated on the device (ops/threefry.py). Every transform is one launch
of kernel K2 (ops/ntt4_fused.py). The device program is eager PyTorch on
int32/int64 tensors: CUDA has native 64-bit integer multiply and
remainder, so every step is exact and the result is bit-equal to the JAX
program's.

``device`` takes the place of the JAX service's ``backend``: on a card the
program runs there with K2; with ``device="cpu"`` the same program runs on
CPU tensors, where K2's wrapper takes its plain version. The numpy host
twins (``_trunc_mac_numpy``, ``_trunc_mac_q1_numpy``, ``_packed_mac_numpy``:
butterfly NTT, natural order) are the independent oracle the tests hold the
program against; no served path falls back to them.

``CKKSComputeService`` (numpy) is the host twin and oracle of the CKKS
device program (engine/ckks_device.py), which shares ``key_switch`` with
the packed program. Not ported: the BFV ``encrypted_scores`` /
``encrypted_scores_batch`` (whole result ciphertexts), which no served
path of either package calls.
"""

from __future__ import annotations

import base64
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.crypto.bfv import BFVContext, Ciphertext, RelinKey
from prefhetch_tpu_torch.crypto.ckks import (
    CKKSContext, GaloisKey, combine_window, rotation_steps,
)
from prefhetch_tpu_torch.crypto.ntt import build_tables, intt, ntt
from prefhetch_tpu_torch.crypto.params import BFVParams
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.ops.ntt4 import (
    build_ntt4_tables, fourstep_perm, intt4, modmul, ntt4,
)
from prefhetch_tpu_torch.ops.threefry import tf_uniform_rns
from prefhetch_tpu_torch.utils.stages import stage


def key_switch(c1g: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
               tabs, digit_bits: int):
    """Hybrid key switch on the device, shared by the packed BFV program
    and the CKKS program (engine/ckks_device.py, at its active level).

    c1g [M, l, N]: canonical coefficient-domain residues mod the first l
    primes of ``tabs``; kb, ka [l·n_digits, l+1, N] int32: the key's rows
    for those primes and the special prime (the last of ``tabs``), NTT
    domain in four-step order → (ks0, ks1) [M, l, N] int64 canonical.

    Per extension prime: one forward K2 over all (row, digit) polys, Σ of
    the n_comp reduced products (< 2^35, far inside int64), one inverse K2
    of both halves; then the special prime's residue, centred, is divided
    out exactly. The products live one prime at a time."""
    M, l, n = c1g.shape
    n_digits = -(-30 // digit_bits)
    n_comp = l * n_digits
    dmask = (1 << digit_bits) - 1
    digits = torch.stack(
        [(c1g[:, i] >> (dd * digit_bits)) & dmask
         for i in range(l) for dd in range(n_digits)], dim=1)
    flat = digits.reshape(M * n_comp, n)
    acc0, acc1 = [], []
    for e, tb in enumerate(tabs):
        D = ntt4(flat, tb).reshape(M, n_comp, n)
        s0 = modmul(D, kb[:, e], tb.q).sum(1) % tb.q
        s1 = modmul(D, ka[:, e], tb.q).sum(1) % tb.q
        del D
        i01 = intt4(torch.cat([s0, s1]), tb).to(torch.int64)
        acc0.append(i01[:M])
        acc1.append(i01[M:])
    sp = tabs[-1].q
    cp0 = torch.where(acc0[-1] > sp // 2, acc0[-1] - sp, acc0[-1])
    cp1 = torch.where(acc1[-1] > sp // 2, acc1[-1] - sp, acc1[-1])
    out0, out1 = [], []
    for i in range(l):
        q = tabs[i].q
        inv_p = pow(sp, -1, q)
        out0.append((acc0[i] - cp0) % q * inv_p % q)
        out1.append((acc1[i] - cp1) % q * inv_p % q)
    return torch.stack(out0, 1), torch.stack(out1, 1)


class HEComputeService:
    """Holds a BFV parameter context (no keys) + the batched MAC program."""

    def __init__(self, params: BFVParams,
                 device: "str | torch.device" = "cuda"):
        self.params = params
        self.ctx = BFVContext(params)
        self.device = resolve_device(device)
        self._tables = [build_ntt4_tables(q, params.n) for q in params.qs]
        perm, inv_perm = fourstep_perm(self._tables[0])
        self._perm = torch.from_numpy(perm).to(self.device)
        self._inv_perm = torch.from_numpy(inv_perm).to(self.device)
        self._base_host: np.ndarray | None = None
        self._base_dev: torch.Tensor | None = None
        self._galois_bfv: Dict[str, Dict[int, RelinKey]] = {}
        self._packed_keys_dev: Dict[str, tuple] = {}
        self._packed_shift_cache: Dict[tuple, tuple] = {}

    # -- truncated-response device pipeline ------------------------------
    def set_base(self, base) -> None:
        """Register the integer base matrix (numpy array or tensor) so
        requests upload only candidate INDICES; packing/gather runs on the
        device. A zero row is appended at index nbase for block padding.
        The int32 copy stays on the device ((nbase+1)·d·4 bytes) and on the
        host (candidate norms)."""
        b = torch.round(torch.as_tensor(base)).to(torch.int32)
        b = torch.cat([b, torch.zeros((1, b.shape[1]), dtype=torch.int32,
                                      device=b.device)])
        self._base_dev = b.to(self.device)
        self._base_host = b.cpu().numpy()

    def _mac_limbs(self, ctq: torch.Tensor, rows: torch.Tensor):
        """The ct×pt MAC shared by both response wires. Yields, per limb,
        (tables, o0, o1): the c0 and c1 products [nq, nb, N] int64 in
        four-step NTT order.

        The incoming ciphertext is natural-order NTT and is permuted to
        four-step order once; the candidate rows [nq, npad, d] int32 (B rows
        a block) are each REVERSED in their d-aligned window, and negatives
        are lifted per limb before the forward transform."""
        n = self.params.n
        nq, npad, d = rows.shape
        nb = npad * d // n
        c0q = ctq[:, 0][..., self._perm]
        c1q = ctq[:, 1][..., self._perm]
        polys = rows.flip(-1).reshape(nq * nb, n)
        for i, tb in enumerate(self._tables):
            q = tb.q
            lifted = torch.where(polys < 0, polys + q, polys)
            pt = ntt4(lifted, tb).reshape(nq, nb, n)
            yield (tb, modmul(c0q[:, None, i], pt, q),
                   modmul(c1q[:, None, i], pt, q))

    @staticmethod
    def _ip_coeffs(o0: torch.Tensor, tb, d: int) -> torch.Tensor:
        """Inverse-NTT the c0 products and keep the B inner-product
        coefficients (positions j·d + d−1) of each block: [nq, nb, B] i32."""
        nq, nb, n = o0.shape
        return intt4(o0.reshape(nq * nb, n), tb).reshape(
            nq, nb, n // d, d)[..., d - 1]

    def _trunc_mac(self, ctq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(ctq [nq, 2, L, N] i32 natural-order NTT (c0, c1 bundled),
        idx [nq, npad] i32) → bundled [nq, nb, L, N+B] i32 (c1_ntt ‖ c0_ip).

        Response layout (the truncated wire, ~4× smaller than full cts):
        - c1 of each result ct stays in NTT domain (the client multiplies by
          NTT(s) anyway, so this SAVES it a forward NTT);
        - c0 is inverse-NTT'd on device and only the B inner-product
          coefficients are kept.

        Transforms run in four-step order (ops/ntt4.py); the wire stays
        NATURAL NTT order via two device permutations, so clients are
        unaffected. The rows are gathered from the parked base."""
        rows = self._base_dev[idx.long()]                # [nq, npad, d] i32
        out = []
        for tb, o0, o1 in self._mac_limbs(ctq, rows):
            o1_nat = o1[..., self._inv_perm]             # wire: natural order
            out.append(torch.cat(
                [o1_nat.to(torch.int32),
                 self._ip_coeffs(o0, tb, rows.shape[-1])], dim=-1))
        return torch.stack(out, dim=2)                   # [nq, nb, L, N+B]

    def _trunc_mac_q1(self, ctq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Modulus-switched truncated MAC: same inputs as ``_trunc_mac``
        → bundled [nq, nb, N+B] i32, everything mod q1, over the rows
        gathered from the parked base (``trunc_mac_q1_rows``)."""
        return self.trunc_mac_q1_rows(self._base_dev[idx.long()], ctq)

    def trunc_mac_q1_rows(self, rows: torch.Tensor,
                          ctq: torch.Tensor) -> torch.Tensor:
        """The q1 MAC core on given candidate rows: (rows [nq, npad, d] i32,
        ctq [nq, 2, L, N] i32 natural-order NTT) → bundled [nq, nb, N+B]
        i32, everything mod q1. The sharded path
        (parallel/sharded.sharded_trunc_mac_q1) runs it a query shard at a
        time; the arithmetic is exact, so the shards' results are bit-equal
        to one device's.

        Same MAC as ``_trunc_mac``, but the result ciphertext is RNS
        mod-switched down to the FIRST limb before it leaves the device —
        the wire shrinks ~2× (c1 in COEFFICIENT domain ‖ c0 inner-product
        coefficients, both mod q1).

        Domain subtlety: RNS mod-down centers the q2-residue per
        coefficient, which is only meaningful in the COEFFICIENT domain —
        mod-switching NTT-domain values would turn the ±1/2 rounding into
        full-magnitude coefficient noise after iNTT. So c1 pays one extra
        device iNTT per limb and ships in coefficient domain; the client
        forward-NTTs it at q1 only.

        Noise budget (deterministic): Δ' = q1/t ≈ 2^6; mod-down error
        ≤ (1+‖s‖₁)/2 + |e⊛pt|/q2 + t/q2 < 25 + 0.02 + 0.01 < Δ'/2 = 32
        for a sparse ternary secret with h = ‖s‖₁ ≤ 48
        (crypto/bfv._sample_sparse_ternary). Dense ternary keys would NOT
        decrypt — callers of resp_mod="q1" must use HEParams.sparse_h."""
        q1, q2 = self.params.qs
        inv_q2 = pow(q2 % q1, -1, q1)
        c1c, c0ip = [], []
        for tb, o0, o1 in self._mac_limbs(ctq, rows):
            nq, nb, n = o1.shape
            c0ip.append(self._ip_coeffs(o0, tb, rows.shape[-1])
                        .to(torch.int64))
            c1c.append(intt4(o1.reshape(nq * nb, n), tb)
                       .reshape(nq, nb, n).to(torch.int64))   # coeff domain

        def mod_down(x1, x2):
            # residues mod q1 / mod q2 → value mod q1 after exact division
            # by q2 (centred q2-residue); |x1 − r2c| < 2^31 times
            # inv_q2 < 2^30 stays in int64, and % returns [0, q1)
            r2c = torch.where(x2 > q2 // 2, x2 - q2, x2)
            return (x1 - r2c) * inv_q2 % q1

        return torch.cat([
            mod_down(c1c[0], c1c[1]).to(torch.int32),
            mod_down(c0ip[0], c0ip[1]).to(torch.int32),
        ], dim=-1)                                        # [nq, nb, N+B]

    # -- host twins: the independent oracle --------------------------------
    def _mac_limbs_numpy(self, c0q, c1q, idx):
        """Host twin of ``_mac_limbs`` (butterfly NTT, natural order):
        yields (tables, o0, o1) with the products [nq, nb, N] int64."""
        n = self.params.n
        nq, npad = idx.shape
        nb = npad * self._base_host.shape[1] // n
        rows = self._base_host[idx].astype(np.int64)     # [nq, npad, d]
        polys = rows[:, :, ::-1].reshape(nq * nb, n)
        for i, tb in enumerate(self.ctx.tables):
            q = tb.q
            pt = ntt(polys % q, tb).reshape(nq, nb, n)
            yield (tb, c0q[:, None, i].astype(np.int64) * pt % q,
                   c1q[:, None, i].astype(np.int64) * pt % q)

    def _ip_coeffs_numpy(self, o0: np.ndarray, tb) -> np.ndarray:
        nq, nb, n = o0.shape
        d = self._base_host.shape[1]
        return intt(o0.reshape(nq * nb, n), tb).reshape(
            nq, nb, n // d, d)[..., d - 1]

    def _trunc_mac_numpy(self, c0q, c1q, idx):
        """Host twin of ``_trunc_mac``: (c1_ntt [nq,nb,L,N] i32, c0_ip
        [nq,nb,L,B] i32)."""
        c1, c0ip = [], []
        for tb, o0, o1 in self._mac_limbs_numpy(c0q, c1q, idx):
            c1.append(o1.astype(np.int32))
            c0ip.append(self._ip_coeffs_numpy(o0, tb).astype(np.int32))
        return np.stack(c1, axis=2), np.stack(c0ip, axis=2)

    def _trunc_mac_q1_numpy(self, c0q, c1q, idx):
        """Host twin of ``_trunc_mac_q1``: bundled [nq, nb, N+B] i32."""
        q1, q2 = self.params.qs
        inv_q2 = pow(q2 % q1, -1, q1)
        c1c, c0ip = [], []
        for tb, o0, o1 in self._mac_limbs_numpy(c0q, c1q, idx):
            nq, nb, n = o1.shape
            c0ip.append(self._ip_coeffs_numpy(o0, tb))
            c1c.append(intt(o1.reshape(nq * nb, n), tb).reshape(nq, nb, n))

        def mod_down(x1, x2):
            r2c = np.where(x2 > q2 // 2, x2 - q2, x2)
            return (x1 - r2c) * inv_q2 % q1

        return np.concatenate(
            [mod_down(c1c[0], c1c[1]).astype(np.int32),
             mod_down(c0ip[0], c0ip[1]).astype(np.int32)], axis=-1,
        )

    # -- requests -----------------------------------------------------------
    def prepare(self, cts: List[Ciphertext], cand_idx: np.ndarray):
        """Host side of a request: (ctq [nq, 2, L, N] i32, pad_idx
        [nq, nb·B] i32 padded with the zero row, norms [nq, P] i64)."""
        if self._base_host is None:
            raise RuntimeError("call set_base() first")
        with stage("prepare (stack, pad, norms)"):
            return self._prepare(cts, cand_idx)

    def _prepare(self, cts: List[Ciphertext], cand_idx: np.ndarray):
        cts = [self.ctx.to_ntt(c) if not c.is_ntt else c for c in cts]
        ctq = np.stack(
            [np.stack([c.c0 for c in cts]), np.stack([c.c1 for c in cts])],
            axis=1,
        ).astype(np.int32)                                # [nq, 2, L, N]
        return (ctq,) + self._pad_and_norms(cand_idx)

    def _pad_and_norms(self, cand_idx: np.ndarray):
        """(pad_idx [nq, nb·B] i32 padded with the zero row, candidate
        squared norms [nq, P] i64)."""
        nq, P = cand_idx.shape
        d = self._base_host.shape[1]
        B = self.params.n // d
        nb = -(-P // B)
        pad_idx = np.full((nq, nb * B), self._base_host.shape[0] - 1, np.int32)
        pad_idx[:, :P] = cand_idx
        gathered = self._base_host[cand_idx.astype(np.int64)].astype(np.int64)
        return pad_idx, (gathered ** 2).sum(-1)

    def upload(self, ctq: np.ndarray, pad_idx: np.ndarray):
        with stage("upload"):
            return (torch.from_numpy(ctq).to(self.device),
                    torch.from_numpy(pad_idx).to(self.device))

    def encrypted_scores_trunc(
        self,
        cts: List[Ciphertext],        # [nq] NTT-domain encrypted queries
        cand_idx: np.ndarray,         # [nq, P] int candidate row indices
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched truncated-response MACs over the registered base matrix.

        Returns (c1_ntt [nq,nb,L,N] i32, c0_ip [nq,nb,L,B] i32,
        norms [nq,P] i64). Uploads only query cts + indices; the candidate
        gather, packing, NTTs, MACs, and c0 truncation all run on the
        service's device."""
        bundled, norms = self.encrypted_scores_trunc_async(cts, cand_idx)
        with stage("download"):
            host = bundled.cpu().numpy()
        return self.trunc_unbundle(host, norms)

    def encrypted_scores_trunc_async(
        self, cts: List[Ciphertext], cand_idx: np.ndarray
    ):
        """Enqueue the truncated MAC; returns (bundled, norms) where bundled
        is a device tensor [nq, nb, L, N+B] i32 not yet copied to the host —
        callers can overlap the download with the next batch's host work,
        then call trunc_unbundle(bundled.cpu().numpy(), norms)."""
        ctq, pad_idx, norms = self.prepare(cts, cand_idx)
        ctq_d, idx_d = self.upload(ctq, pad_idx)
        with stage("device program"):
            return self._trunc_mac(ctq_d, idx_d), norms

    def trunc_unbundle(self, bundled: np.ndarray, norms: np.ndarray):
        """[nq, nb, L, N+B] → (c1_ntt [nq,nb,L,N], c0_ip [nq,nb,L,B], norms)."""
        n = self.params.n
        return bundled[..., :n], bundled[..., n:], norms

    def encrypted_scores_trunc_q1(
        self, cts: List[Ciphertext], cand_idx: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Modulus-switched truncated MACs → (c1_q1 [nq,nb,N] i32 coeff-dom,
        c0_ip [nq,nb,B] i32, norms [nq,P] i64) — all mod q1 only; ~2× less
        wire than encrypted_scores_trunc."""
        bundled, norms = self.encrypted_scores_trunc_q1_async(cts, cand_idx)
        with stage("download"):
            host = bundled.cpu().numpy()
        return self.trunc_unbundle_q1(host, norms)

    def encrypted_scores_trunc_q1_async(
        self, cts: List[Ciphertext], cand_idx: np.ndarray
    ):
        if len(self.params.qs) != 2:
            raise ValueError("the q1 response wire needs exactly 2 RNS limbs")
        ctq, pad_idx, norms = self.prepare(cts, cand_idx)
        ctq_d, idx_d = self.upload(ctq, pad_idx)
        with stage("device program"):
            return self._trunc_mac_q1(ctq_d, idx_d), norms

    def trunc_unbundle_q1(self, bundled: np.ndarray, norms: np.ndarray):
        """[nq, nb, N+B] → (c1_q1 [nq,nb,N], c0_ip [nq,nb,B], norms)."""
        n = self.params.n
        return bundled[..., :n], bundled[..., n:], norms

    # -- packed single-ct response ----------------------------------------
    # The q1 wire still ships one full c1 poly per (query, block). This mode
    # extracts the inner-product coefficients with the SealPIR automorphisms
    # run in the killing direction (BFVContext.extraction_elts), then
    # monomial-shifts every (query, block) result to a distinct coefficient
    # offset and SUMS d/nb queries' worth of blocks into ONE 2-limb
    # ciphertext. Needs client-registered Galois keys (public) and an ODD
    # plaintext modulus on the client (bfv_params_for odd_t) so the ×d
    # extraction factor inverts there; t never enters the server's ring
    # operations. Fills the same reference slot as the other response modes
    # (include/client/client_lib.h:28-30).

    def register_galois_keys(self, key_id: str, gks_wire: dict) -> None:
        """Register client-generated extraction keys {g: RelinKey wire}."""
        keys = {int(g): RelinKey.from_wire(w) for g, w in gks_wire.items()}
        L = len(self.params.qs)
        ext = tuple(self.params.qs) + (self.ctx._special_p,)
        for g, rk in keys.items():
            # the device key switch derives the digit ladder from the key
            # SHAPE (n_digits = n_comp/L, digit_bits = 30/n_digits) — a
            # wire whose declared width disagrees would silently corrupt
            if 30 % rk.digit_bits or (
                rk.b.shape[0] != L * (30 // rk.digit_bits)
            ):
                raise ValueError(
                    f"galois key {g}: digitBits {rk.digit_bits} / shape "
                    f"{rk.b.shape} inconsistent with {L} limbs"
                )
            if tuple(rk.ext) != ext or rk.b.shape[1:] != (
                    L + 1, self.params.n) or rk.a.shape != rk.b.shape:
                raise ValueError(
                    f"galois key {g}: basis {tuple(rk.ext)} / shape "
                    f"{rk.b.shape} does not match the service's {ext}"
                )
        self._galois_bfv[key_id] = keys
        self._packed_keys_dev.pop(key_id, None)

    def has_galois_keys(self, key_id: str) -> bool:
        return key_id in self._galois_bfv

    def _packed_layout(self, key_id: str, nq: int, cand_idx: np.ndarray):
        """The packed layout of a request of nq queries with P candidates
        each: (nb blocks, G queries per output ct), after the refusals: no
        base, nq against the candidate rows, an unknown keyId, a layout
        that does not fit the coefficient stride, a missing extraction
        element."""
        cand_rows, P = cand_idx.shape
        if self._base_host is None:
            raise RuntimeError("call set_base() first")
        if nq != cand_rows:
            raise ValueError(f"{nq} query ciphertexts for {cand_rows} "
                             f"candidate rows")
        gks = self._galois_bfv.get(key_id)
        if gks is None:
            raise ValueError("unknown BFV keyId — register Galois keys first")
        n = self.params.n
        d = self._base_host.shape[1]
        B = n // d
        nb = -(-P // B)
        G = max(1, d // nb)
        if G * nb > d:
            raise ValueError(
                "packed response needs ceil(P/B) <= d blocks "
                f"(P={P}, B={B}, d={d})"
            )
        for g in self.ctx.extraction_elts(n, d):
            if g not in gks:
                raise ValueError(f"missing Galois key for element {g}")
        return nb, G

    def encrypted_scores_packed(
        self,
        cts: List[Ciphertext],        # [nq] NTT-domain encrypted queries
        cand_idx: np.ndarray,         # [nq, P] int candidate row indices
        key_id: str,
    ) -> Tuple[List[Ciphertext], np.ndarray, int]:
        """Batched MAC + coefficient extraction + shift-pack.

        Returns ([n_out] coeff-domain 2-limb Ciphertexts, norms [nq, P],
        G = queries per output ct). Query qi's inner product with candidate
        b·B + j sits at plaintext coefficient j·d + (qi mod G)·nb + b of
        output ct qi//G, scaled by d (client multiplies by d⁻¹ mod t —
        HEClient.decrypt_scores_packed)."""
        return self.encrypted_scores_packed_async(cts, cand_idx, key_id)()

    def encrypted_scores_packed_async(
        self, cts: List[Ciphertext], cand_idx: np.ndarray, key_id: str
    ):
        """Enqueue the packed program on host-expanded ciphertexts; returns
        a zero-arg resolver → (packed cts, norms, G) that downloads the
        result, so callers can overlap the download with the next batch's
        host work. ``resolver.dev_out`` is the device result
        [n_out, 2, L, N] int32."""
        nb, G = self._packed_layout(key_id, len(cts), cand_idx)
        ctq, pad_idx, norms = self.prepare(cts, cand_idx)
        ctq_d, idx_d = self.upload(ctq, pad_idx)
        args = self._packed_args(key_id, nb, G)
        with stage("device program"):
            out = self._packed_program(ctq_d[:, 0][..., self._perm],
                                       ctq_d[:, 1][..., self._perm],
                                       idx_d, *args)
        return self._packed_resolver(out, norms, G)

    def encrypted_scores_packed_wire(
        self, wires: List[dict], cand_idx: np.ndarray, key_id: str
    ):
        return self.encrypted_scores_packed_wire_async(
            wires, cand_idx, key_id)()

    def encrypted_scores_packed_wire_async(
        self, wires: List[dict], cand_idx: np.ndarray, key_id: str
    ):
        """Packed response straight from ct WIRES. For ``seedTf`` wires
        only c0, the 8-byte threefry keys and the indices are uploaded: the
        c1 mask is regenerated inside the device program
        (ops/threefry.py), so no host expansion or NTT of c1 happens.
        Other wire forms are expanded on the host (ct_from_wire)."""
        if not all("seedTf" in w for w in wires):
            with stage("ct_from_wire (c1 expansion + host NTT)"):
                cts = [self.ctx.ct_from_wire(w) for w in wires]
            return self.encrypted_scores_packed_async(cts, cand_idx, key_id)
        nb, G = self._packed_layout(key_id, len(wires), cand_idx)
        L, n = len(self.params.qs), self.params.n
        with stage("wire decode (c0 + seeds)"):
            c0s = np.stack([
                np.frombuffer(base64.b64decode(w["c0"]), "<u4").reshape(L, n)
                for w in wires]).astype(np.int32)
            seeds = [w["seedTf"] for w in wires]
            if not all(isinstance(s, (list, tuple)) and len(s) == 2
                       and all(type(v) is int and 0 <= v < 1 << 32
                               for v in s) for s in seeds):
                raise ValueError("seedTf must be two uint32 words a query")
            seeds = np.array(seeds, np.int64)
        with stage("prepare (pad, norms)"):
            pad_idx, norms = self._pad_and_norms(cand_idx)
        with stage("upload"):
            c0_d, seeds_d, idx_d = (torch.from_numpy(x).to(self.device)
                                    for x in (c0s, seeds, pad_idx))
        args = self._packed_args(key_id, nb, G)
        with stage("device program"):
            out = self._packed_seeded(c0_d, seeds_d, idx_d, *args)
        return self._packed_resolver(out, norms, G)

    @staticmethod
    def _packed_resolver(dev_out: torch.Tensor, norms: np.ndarray, G: int):
        def resolve():
            with stage("download"):
                packed = dev_out.cpu().numpy().astype(np.int64)
            return ([Ciphertext(c0=c[0], c1=c[1], is_ntt=False)
                     for c in packed], norms, G)

        resolve.dev_out = dev_out
        return resolve

    # -- packed response: host oracle --------------------------------------
    def _packed_mac_numpy(
        self, ctq: np.ndarray, pad_idx: np.ndarray, gks: dict
    ) -> np.ndarray:
        """Host twin of the packed program (butterfly NTT, natural order;
        ctq [nq, 2, L, N] natural-order NTT domain) → [n_out, 2, L, N]
        int64 coeff-domain residues."""
        p = self.params
        n = p.n
        qs = np.array(p.qs, np.int64)[None, :, None]
        nq, npad = pad_idx.shape
        d = self._base_host.shape[1]
        B = n // d
        nb = npad // B
        G = max(1, d // nb)
        M = nq * nb
        rows = self._base_host[pad_idx].astype(np.int64)
        polys = rows[:, :, ::-1].reshape(M, n)
        # X^{-(d-1)} pre-shift folded into the MAC: IPs land at coeffs j·d
        e0 = (2 * n - (d - 1)) % (2 * n)
        mono = np.zeros(n, np.int64)
        mono[e0 % n] = 1 if e0 < n else -1
        c0p = np.empty((M, len(p.qs), n), np.int64)
        c1p = np.empty_like(c0p)
        for i, tb in enumerate(self.ctx.tables):
            q = tb.q
            pt = ntt(polys % q, tb).reshape(nq, nb, n)
            mono_ntt = ntt(mono % q, tb)
            o1 = ctq[:, None, 1, i].astype(np.int64) * pt % q * mono_ntt % q
            o0 = ctq[:, None, 0, i].astype(np.int64) * pt % q * mono_ntt % q
            c0p[:, i] = intt(o0.reshape(M, n), tb)
            c1p[:, i] = intt(o1.reshape(M, n), tb)
        # kill every coefficient except the j·d inner products (×d factor)
        for g in self.ctx.extraction_elts(n, d):
            c0g, c1g = self.ctx.apply_galois_batch(c0p, c1p, g, gks[g])
            c0p = np.mod(c0p + c0g, qs)
            c1p = np.mod(c1p + c1g, qs)
        # shift row (qi, b) by X^{(qi mod G)·nb + b}, sum groups of G queries
        k = np.arange(n)
        out = np.zeros((-(-nq // G), 2, len(p.qs), n), np.int64)
        for qi in range(nq):
            for b in range(nb):
                dest = (k + (qi % G) * nb + b) % (2 * n)
                sign = np.where(dest < n, 1, -1)
                m = qi * nb + b
                for comp, arr in ((0, c0p), (1, c1p)):
                    shifted = np.zeros((len(p.qs), n), np.int64)
                    shifted[:, dest % n] = arr[m] * sign[None, :]
                    out[qi // G, comp] = np.mod(
                        out[qi // G, comp] + shifted, qs[0])
        return out

    # -- packed response: the device program -------------------------------
    @functools.cached_property
    def _packed_tables(self):
        """(ext basis qs + (special p,), its four-step NTT tables, the
        natural → four-step permutation as numpy)."""
        ext = tuple(self.params.qs) + (self.ctx._special_p,)
        tabs = [build_ntt4_tables(q, self.params.n) for q in ext]
        return ext, tabs, fourstep_perm(tabs[0])[0]

    def _packed_args(self, key_id: str, nb: int, G: int):
        """The device arguments of the packed program after the queries and
        indices: the key tables and the monomial tables."""
        return (*self._packed_dev_keys(key_id),
                *self._packed_shift_tables(nb, G))

    def _packed_shift_tables(self, nb: int, G: int):
        """(mono_pre [L, N] = NTT(X^{-(d-1)}), shift_tabs [L, G·nb, N] =
        NTT(X^{g·nb+b})), int64 on the device, in FOUR-STEP order (the
        order of K2's forward output): a natural-order table would multiply
        the wrong slots and still give valid ciphertexts. Cached per
        layout."""
        d = self._base_host.shape[1]
        key = (d, nb, G)
        if key not in self._packed_shift_cache:
            n = self.params.n
            four_perm = self._packed_tables[2]
            pre_e = (2 * n - (d - 1)) % (2 * n)
            shifts = [g * nb + b for g in range(G) for b in range(nb)]

            def mono_rows(es, q, tb):
                rows = np.zeros((len(es), n), np.int64)
                for r, e in enumerate(es):
                    rows[r, e % n] = 1 if e < n else q - 1
                return ntt(rows, tb)[:, four_perm]

            pre, sh = [], []
            for q, tb in zip(self.params.qs, self.ctx.tables):
                pre.append(mono_rows([pre_e], q, tb)[0])
                sh.append(mono_rows(shifts, q, tb))
            self._packed_shift_cache[key] = (
                torch.from_numpy(np.stack(pre)).to(self.device),
                torch.from_numpy(np.stack(sh)).to(self.device))
        return self._packed_shift_cache[key]

    def _packed_dev_keys(self, key_id: str):
        """(kb, ka [n_elts, n_comp, n_ext, N] int32 NTT domain in four-step
        order, perms [n_elts, N] int64, negs [n_elts, N] bool: the
        automorphism maps), on the device, cached per key_id."""
        if key_id not in self._packed_keys_dev:
            with stage("galois key tables (host NTT, once per key)"):
                self._packed_keys_dev[key_id] = self._dev_keys(key_id)
        return self._packed_keys_dev[key_id]

    def _dev_keys(self, key_id: str):
        n = self.params.n
        d = self._base_host.shape[1]
        ext, _, four_perm = self._packed_tables
        ext_tables = [build_tables(q, n) for q in ext]
        gks = self._galois_bfv[key_id]
        kbs, kas, perms, negs = [], [], [], []
        for g in self.ctx.extraction_elts(n, d):
            rk = gks[g]
            kb = np.empty(rk.b.shape, np.int32)
            ka = np.empty(rk.a.shape, np.int32)
            for e, (q, tb) in enumerate(zip(ext, ext_tables)):
                kb[:, e] = ntt(rk.b[:, e] % q, tb)[:, four_perm]
                ka[:, e] = ntt(rk.a[:, e] % q, tb)[:, four_perm]
            kbs.append(kb)
            kas.append(ka)
            pm, sg = self.ctx._automorphism_map(g)
            perms.append(pm)
            negs.append(sg < 0)
        return tuple(torch.from_numpy(np.stack(x)).to(self.device)
                     for x in (kbs, kas, perms, negs))

    def _packed_program(self, c0q, c1q, idx, kb, ka, perms, negs,
                        mono_pre, shift_tabs) -> torch.Tensor:
        """The packed program: (c0q, c1q [nq, L, N] FOUR-STEP NTT domain,
        idx [nq, nb·B] i32, the key and monomial tables) → [n_out, 2, L, N]
        int32 coeff-domain packed response ciphertexts.

        1. MAC with the X^{-(d-1)} pre-shift, per limb: one forward K2 of
           the gathered, reversed, lifted rows, NTT-domain multiplies by
           mono_pre and by c0/c1, one inverse K2 of both halves;
        2. log2(d) extraction rounds ct += σ_g(ct): an automorphism gather
           with its sign and a key switch (``key_switch``);
        3. the shift-pack, per limb: one forward K2 of both halves, a
           multiply by each row's monomial NTT(X^{(qi mod G)·nb + b}), the
           sum over groups of G·nb rows (< 2^37, exact), one inverse K2.

        Only the nq·nb real rows are computed: absent queries of the last
        group contribute nothing, as the zero ciphertexts they stand for
        would (the JAX program pads the batch to a multiple of G)."""
        p = self.params
        n, L = p.n, len(p.qs)
        tabs = self._packed_tables[1]
        nq, npad = idx.shape
        d = self._base_dev.shape[1]
        nb = npad * d // n
        gnb = shift_tabs.shape[1]                    # G·nb
        M = nq * nb
        n_out = -(-M // gnb)
        qs = torch.tensor(p.qs, dtype=torch.int64, device=idx.device)[:, None]
        polys = self._base_dev[idx.long()].flip(-1).reshape(M, n)
        c0, c1 = [], []
        for i in range(L):
            tb = tabs[i]
            lifted = torch.where(polys < 0, polys + tb.q, polys)
            pt = modmul(ntt4(lifted, tb), mono_pre[i], tb.q).reshape(nq, nb, n)
            o0 = modmul(c0q[:, None, i], pt, tb.q).reshape(M, n)
            o1 = modmul(c1q[:, None, i], pt, tb.q).reshape(M, n)
            i01 = intt4(torch.cat([o0, o1]), tb).to(torch.int64)
            c0.append(i01[:M])
            c1.append(i01[M:])
        c0 = torch.stack(c0, 1)                       # [M, L, N] coeff
        c1 = torch.stack(c1, 1)
        # the digit ladder from the keys' shape: n_comp = L·n_digits rows,
        # digit_bits = 30/n_digits (30-bit keys: n_comp = L)
        digit_bits = 30 // (kb.shape[1] // L)
        for r in range(perms.shape[0]):
            perm, neg = perms[r], negs[r]
            v0, v1 = c0[:, :, perm], c1[:, :, perm]
            c0g = torch.where(neg & (v0 != 0), qs - v0, v0)
            c1g = torch.where(neg & (v1 != 0), qs - v1, v1)
            ks0, ks1 = key_switch(c1g, kb[r], ka[r], tabs, digit_bits)
            c0 = (c0 + c0g + ks0) % qs
            c1 = (c1 + ks1) % qs
        outs = []
        for i in range(L):
            tb = tabs[i]
            nt = ntt4(torch.cat([c0[:, i], c1[:, i]]), tb).reshape(2, M, n)
            sh = modmul(nt, shift_tabs[i].repeat(n_out, 1)[None, :M], tb.q)
            sh = torch.nn.functional.pad(sh, (0, 0, 0, n_out * gnb - M))
            s01 = sh.reshape(2 * n_out, gnb, n).sum(1) % tb.q
            outs.append(intt4(s01, tb).reshape(2, n_out, n).transpose(0, 1))
        return torch.stack(outs, 2)                   # [n_out, 2, L, N] i32

    def _packed_seeded(self, c0_nat, seeds, idx, *args) -> torch.Tensor:
        """The seedTf entry: c0 [nq, L, N] natural-order NTT domain, seeds
        [nq, 2]. The c1 mask a is regenerated from the 8-byte threefry keys
        (ops/threefry.py, plain PyTorch) and forward-transformed by one K2
        per limb; then the packed program."""
        tabs = self._packed_tables[1]
        a = tf_uniform_rns(seeds, self.params.qs, self.params.n)
        c1q = torch.stack([ntt4(a[:, i], tabs[i])
                           for i in range(len(self.params.qs))], 1)
        return self._packed_program(c0_nat[..., self._perm], c1q, idx, *args)


class CKKSComputeService:
    """CKKS slot-packed scoring on the host (BASELINE config 3), numpy: the
    port of the JAX package's ``CKKSComputeService``. It is the host twin
    and the oracle of the device program (engine/ckks_device.py
    ``DeviceCKKS``), as ``_packed_mac_numpy`` is for the packed wire; no
    served path runs it.

    Slot layout: the query arrives replicated across all N/2 slots; the
    server packs slots/d candidates per plaintext, multiplies slot-wise, and
    rotate-accumulates log2(d) times so slot j·d carries ⟨q, x_j⟩. Rotations
    use client-registered Galois keys (public; registered once per key id —
    the server still holds NO secret material)."""

    # candidates scaled 2^-CAND_SCALE_BITS at encode so the inner products
    # fit ONE 30-bit limb after two rescales; the mask plaintext's scale
    # sets the final precision (see encrypted_scores_combined)
    CAND_SCALE_BITS = 16
    # 29 puts the worst-case message (IP=128·255², i.e. 2^7 after the 2^-16
    # candidate scale) at 2^28 against q1/2 ≈ 2^29 — 2× headroom, and each
    # extra scale bit halves the (key-switch-noise-dominated) output error
    MASK_SCALE_BITS = 29

    def __init__(self, params):
        self.params = params
        self.ctx = CKKSContext(params)
        self._galois: dict = {}          # key_id -> {step: GaloisKey}

    def register_keys(self, key_id: str, gks_wire: dict) -> None:
        self._galois[key_id] = {
            int(step): GaloisKey.from_wire(w) for step, w in gks_wire.items()
        }

    def has_keys(self, key_id: str) -> bool:
        return key_id in self._galois

    def encrypted_scores(self, ct, candidates: np.ndarray, key_id: str):
        """Returns (result ciphertexts per block, candidate norms [P])."""
        gks = self._galois[key_id]
        ctx = self.ctx
        P, d = candidates.shape
        slots = self.params.n // 2
        per_ct = slots // d
        n_blocks = -(-P // per_ct)
        padded = np.zeros((n_blocks * per_ct, d), np.float64)
        padded[:P] = candidates

        out = []
        for b in range(n_blocks):
            block = padded[b * per_ct : (b + 1) * per_ct].reshape(-1)
            acc = ctx.mul_plain(ct, ctx.encode(block), ctx.scale)
            for s in rotation_steps(d):
                acc = ctx.add(acc, ctx.rotate(acc, s, gks[s]))
            out.append(acc)
        norms = (np.round(candidates).astype(np.int64) ** 2).sum(-1)
        return out, norms

    def encrypted_scores_combined(self, ct, candidates: np.ndarray,
                                  key_id: str):
        """ONE single-limb result ciphertext for ALL candidates of a query.

        The per-block path (encrypted_scores) returns n_blocks level-2 cts
        per query — ~1 MB at the config-3 operating point, 32 useful slots
        per 4096-slot ciphertext. This variant:

        1. scales candidates by 2^-16 at encode (server-side, exact in
           float64) so every inner product fits a single 30-bit limb;
        2. runs only the IP rotations with stride ≥ W = d/n_blocks before
           combining (the WINDOWED layout — crypto/ckks.combine_window):
           after those, candidate j's partial sums occupy the W slots
           [j·d, j·d + W);
        3. multiplies by the slot mask (1 at slots with offset < W mod d,
           0 elsewhere — one ct×pt whose rescale drops a level), killing
           out-of-window garbage, and tree-combines the blocks with
           rotations by −W·2^k, placing block b's window at [j·d + W·b);
        4. finishes the inner products with the remaining strides < W on
           the ONE combined ct — n_blocks× less rotate-accumulate work on
           the dominant pre-combine side.

        Response: ONE level-1 ct (~16× smaller). The returned ct's `scale`
        is pre-divided by 2^16 so decode() yields RAW inner products; slot
        j·d + W·b carries ⟨q, x_{b·per_ct + j}⟩. The client needs Galois
        keys for the IP tree steps (d/2 … 1) AND the combine steps
        (−W, −2W, … — crypto/ckks.combine_tree_steps). Returns
        (ct, norms [P])."""
        gks = self._galois[key_id]
        ctx = self.ctx
        P, d = candidates.shape
        slots = self.params.n // 2
        per_ct = slots // d
        n_blocks = -(-P // per_ct)
        if n_blocks > 1:
            n_blocks = 1 << (n_blocks - 1).bit_length()   # pow2 tree
        if n_blocks > d:
            raise ValueError("combine needs n_blocks <= d distinct offsets")
        if ct.level < 3:
            raise ValueError("combined scoring needs a level-3 query ct")
        padded = np.zeros((n_blocks * per_ct, d), np.float64)
        padded[:P] = candidates
        cand_scale = float(1 << self.CAND_SCALE_BITS)

        window = combine_window(d, n_blocks)
        steps = rotation_steps(d)
        pre_steps = [s for s in steps if s >= window]
        post_steps = [s for s in steps if s < window]

        mask_slots = np.zeros(slots, np.float64)
        for w in range(window):
            mask_slots[w::d] = 1.0
        mask_scale = float(1 << self.MASK_SCALE_BITS)
        mask_pt = ctx.encode(mask_slots, scale=mask_scale)

        cur = []
        for b in range(n_blocks):
            block = padded[b * per_ct : (b + 1) * per_ct].reshape(-1)
            acc = ctx.mul_plain(
                ct, ctx.encode(block / cand_scale), ctx.scale
            )
            for s in pre_steps:
                acc = ctx.add(acc, ctx.rotate(acc, s, gks[s]))
            cur.append(ctx.mul_plain(acc, mask_pt, mask_scale))
        k = 0
        while len(cur) > 1:
            step = -(window << k)
            cur = [ctx.add(cur[i], ctx.rotate(cur[i + 1], step, gks[step]))
                   for i in range(0, len(cur), 2)]
            k += 1
        out = cur[0]
        for s in post_steps:
            out = ctx.add(out, ctx.rotate(out, s, gks[s]))
        # decode divides by `scale`: report it 2^16 smaller so slot values
        # come back as RAW inner products
        out.scale = out.scale / cand_scale
        norms = (np.round(candidates).astype(np.int64) ** 2).sum(-1)
        return out, norms
