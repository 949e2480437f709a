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
("q1"). Each is one gather, one forward four-step NTT, pointwise modmuls and
inverse NTTs; every transform is one launch of kernel K2
(ops/ntt4_fused.py). The device program is eager PyTorch on int32/int64
tensors: CUDA has native 64-bit integer multiply and remainder, so every
step is exact and the result is bit-equal to the JAX program's.

``device`` takes the place of the JAX service's ``backend``: on a card the
program runs there with K2; with ``device="cpu"`` the same program runs on
CPU tensors, where K2's wrapper takes its plain version. The numpy host
twins (``_trunc_mac_numpy``, ``_trunc_mac_q1_numpy``: butterfly NTT, natural
order) are the independent oracle the tests hold the program against; no
served path falls back to them.

Not ported yet: the packed single-ct response (Galois keys, key switching),
``encrypted_scores``/``encrypted_scores_batch`` (whole result ciphertexts)
and ``CKKSComputeService``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.crypto.bfv import BFVContext, Ciphertext
from prefhetch_tpu_torch.crypto.ntt import intt, ntt
from prefhetch_tpu_torch.crypto.params import BFVParams
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.ops.ntt4 import (
    build_ntt4_tables, fourstep_perm, intt4, modmul, ntt4,
)
from prefhetch_tpu_torch.utils.stages import stage


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

    def _mac_limbs(self, ctq: torch.Tensor, idx: torch.Tensor):
        """The ct×pt MAC shared by both response wires. Yields, per limb,
        (tables, o0, o1): the c0 and c1 products [nq, nb, N] int64 in
        four-step NTT order.

        The incoming ciphertext is natural-order NTT and is permuted to
        four-step order once; the idx rows are gathered from the parked
        base, B rows per block, each REVERSED in its d-aligned window, and
        negatives are lifted per limb before the forward transform."""
        n = self.params.n
        nq, npad = idx.shape
        nb = npad * self._base_dev.shape[1] // n
        c0q = ctq[:, 0][..., self._perm]
        c1q = ctq[:, 1][..., self._perm]
        rows = self._base_dev[idx.long()]                # [nq, npad, d] i32
        polys = rows.flip(-1).reshape(nq * nb, n)
        for i, tb in enumerate(self._tables):
            q = tb.q
            lifted = torch.where(polys < 0, polys + q, polys)
            pt = ntt4(lifted, tb).reshape(nq, nb, n)
            yield (tb, modmul(c0q[:, None, i], pt, q),
                   modmul(c1q[:, None, i], pt, q))

    def _ip_coeffs(self, o0: torch.Tensor, tb) -> torch.Tensor:
        """Inverse-NTT the c0 products and keep the B inner-product
        coefficients (positions j·d + d−1) of each block: [nq, nb, B] i32."""
        nq, nb, n = o0.shape
        d = self._base_dev.shape[1]
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
        unaffected."""
        out = []
        for tb, o0, o1 in self._mac_limbs(ctq, idx):
            o1_nat = o1[..., self._inv_perm]             # wire: natural order
            out.append(torch.cat(
                [o1_nat.to(torch.int32), self._ip_coeffs(o0, tb)], dim=-1))
        return torch.stack(out, dim=2)                   # [nq, nb, L, N+B]

    def _trunc_mac_q1(self, ctq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Modulus-switched truncated MAC: same inputs as ``_trunc_mac``
        → bundled [nq, nb, N+B] i32, everything mod q1.

        Same MAC, but the result ciphertext is RNS mod-switched down to the
        FIRST limb before it leaves the device — the wire shrinks ~2× (c1 in
        COEFFICIENT domain ‖ c0 inner-product coefficients, both mod q1).

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
        for tb, o0, o1 in self._mac_limbs(ctq, idx):
            nq, nb, n = o1.shape
            c0ip.append(self._ip_coeffs(o0, tb).to(torch.int64))
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
        p = self.params
        nq, P = cand_idx.shape
        d = self._base_host.shape[1]
        B = p.n // d
        nb = -(-P // B)
        pad_idx = np.full((nq, nb * B), self._base_host.shape[0] - 1, np.int32)
        pad_idx[:, :P] = cand_idx
        cts = [self.ctx.to_ntt(c) if not c.is_ntt else c for c in cts]
        ctq = np.stack(
            [np.stack([c.c0 for c in cts]), np.stack([c.c1 for c in cts])],
            axis=1,
        ).astype(np.int32)                                # [nq, 2, L, N]
        gathered = self._base_host[cand_idx.astype(np.int64)].astype(np.int64)
        norms = (gathered ** 2).sum(-1)                   # [nq, P]
        return ctq, pad_idx, norms

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
