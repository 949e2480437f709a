"""Device CKKS: slot-packed encrypted scoring with on-device key switching —
the port of prefhetch_tpu/engine/ckks_device.py.

The server side of BASELINE config 3 (N=8192, slot packing) as one device
program a request, eager PyTorch on int64 tensors:

- ct×pt multiply: forward NTTs of the query and the encoded candidate
  blocks, pointwise modular products, inverse NTT, exact RNS rescale;
- slot rotations: the Galois automorphism X → X^{5^s} is a precomputed
  permutation with a sign; the key switch (engine/hecompute.py
  ``key_switch``, shared with the packed BFV program) splits c1 into
  digits, forward-transforms all (row, digit) polys per prime of the
  active level and the special prime, multiplies by the client's
  pre-transformed Galois key, inverse-transforms the two sums and divides
  out the special prime;
- the combined single-ct response: the slot mask (one ct×pt and a
  rescale), the tree combine of the blocks and the post-combine
  rotations on one row a query.

Every forward and inverse transform is one call of ``ops/ntt4.ntt4`` /
``intt4``: one launch of kernel K2 on the card, its plain version on CPU
tensors. Modular products are ``%`` on int64 products, which is exact, so
the program is bit-equal to the JAX one and to the numpy twin
``CKKSComputeService`` (engine/hecompute.py). The JAX program's
``modmul_lazy`` and ``shift_mod_reduce`` emulate 64-bit arithmetic on the
TPU and have no counterpart here.

The candidate encode runs on the device as one f32 matmul against the
real-encode matrix (crypto/ckks.py ``encode_matrix_real``), as the JAX
package computes it with ``lax.dot_general`` outside any Pallas kernel;
TF32 stays off (device.resolve_device). An f32 sum of 4,096 terms of
~2^18 can round a coefficient to a neighbouring integer, so this form is
held bit-equal to the port's own row-upload device encode, and to the host
FFT encode only at small scale. The server holds only PUBLIC key material
(client-registered Galois keys).

What the JAX switches ``PFH_CKKS_BACKEND`` and ``PFH_CKKS_DEV_ENCODE``
chose is fixed here: the engine always runs this program on its own
device, the served combined route gathers from the parked base, and a
caller that wants a row-upload form passes ``dev_encode`` explicitly.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.crypto.ckks import (
    CKKSCiphertext, CKKSContext, GaloisKey, combine_window, rotation_steps,
)
from prefhetch_tpu_torch.crypto.ntt import ntt as host_ntt
from prefhetch_tpu_torch.crypto.params import CKKSParams
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.engine.hecompute import CKKSComputeService, key_switch
from prefhetch_tpu_torch.ops.ntt4 import (
    build_ntt4_tables, fourstep_perm, intt4, modmul, ntt4,
)
from prefhetch_tpu_torch.ops.threefry import tf_uniform_rns
from prefhetch_tpu_torch.utils.stages import stage

CAND_SCALE = float(1 << CKKSComputeService.CAND_SCALE_BITS)
MASK_SCALE = float(1 << CKKSComputeService.MASK_SCALE_BITS)


class DeviceCKKS:
    """Server-side CKKS scoring service on ``device``.

    Same interface as engine.hecompute.CKKSComputeService: register_keys /
    has_keys / encrypted_scores. Slot layout identical (query replicated
    across slots; per_ct = (N/2)/d candidates per plaintext; log2(d)
    rotate-left-accumulate steps leave ⟨q, x_j⟩ in slot j·d)."""

    def __init__(self, params: CKKSParams,
                 device: "str | torch.device" = "cuda"):
        self.params = params
        self.device = resolve_device(device)
        self.ctx = CKKSContext(params)          # host ops: encode, tables
        self.L = len(params.qs)
        self.ext: Tuple[int, ...] = self.ctx.ext          # qs + (p,)
        self._tables = [build_ntt4_tables(q, params.n) for q in self.ext]
        # natural NTT order → four-step order, for every host-NTT'd table
        self._four_perm = fourstep_perm(self._tables[0])[0]
        # key_id -> {step: (kb, ka) [n_comp, L+1, N] int32 NTT domain}
        self._keys: Dict[str, Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = {}
        self._key_digits: Dict[str, int] = {}
        # per (key_id, …) device bundles of a schedule; dropped when the
        # key_id is registered again
        self._sched_cache: Dict[tuple, tuple] = {}
        self._mask_cache: Dict[tuple, torch.Tensor] = {}
        # parked candidate base (set_base): [nbase+1, d] f32 with a zero
        # pad row at index nbase — requests then carry INDICES, not rows
        self._base_dev: torch.Tensor | None = None
        self._enc_mat: torch.Tensor | None = None

    # ------------------------------------------------------------------
    def set_base(self, base) -> None:
        """Park the candidate base (numpy array or tensor) on the device
        with a zero pad row at index nbase. Requests then upload [nq, P]
        candidate indices; the gather, the norms and the encode run in the
        device program."""
        b = torch.as_tensor(base).to(self.device, torch.float32)
        if b.numel() and float(b.abs().max()) >= 16.0 * CAND_SCALE:
            raise ValueError("base values overflow the combined-encode "
                             "headroom")
        self._base_dev = torch.cat(
            [b, torch.zeros((1, b.shape[1]), dtype=b.dtype, device=b.device)])

    # ------------------------------------------------------------------
    def register_keys(self, key_id: str, gks_wire: dict) -> None:
        """Host-NTT every Galois key component over the full extended basis
        into four-step order (once per client) and park it on the device as
        int32.

        The key-switch digit width comes from the key wire itself
        (``digitBits``), validated against the component count; it is
        stored per key_id. Registering a key_id again drops the schedules
        cached for it."""
        n = self.params.n
        out = {}
        dbits = None
        for step_s, wire in gks_wire.items():
            gk = GaloisKey.from_wire(wire)
            n_comp = gk.b.shape[0]
            if dbits is None:
                dbits = int(gk.digit_bits)
                nd = -(-30 // dbits)
            if int(gk.digit_bits) != dbits or n_comp != self.L * nd:
                raise ValueError(
                    f"galois key {step_s}: digitBits {gk.digit_bits} / "
                    f"{n_comp} components inconsistent with "
                    f"digitBits {dbits} (L={self.L})"
                )
            if gk.b.shape[1:] != (self.L + 1, n) or gk.a.shape != gk.b.shape:
                raise ValueError(
                    f"galois key {step_s}: shape {gk.b.shape} does not match "
                    f"the service's {self.L + 1} primes of N={n}"
                )
            kb = np.empty(gk.b.shape, np.int32)
            ka = np.empty(gk.a.shape, np.int32)
            for e, q in enumerate(self.ext):
                tb = self.ctx.tables[e]
                kb[:, e] = host_ntt(gk.b[:, e] % q, tb)[:, self._four_perm]
                ka[:, e] = host_ntt(gk.a[:, e] % q, tb)[:, self._four_perm]
            out[int(step_s)] = (torch.from_numpy(kb).to(self.device),
                                torch.from_numpy(ka).to(self.device))
        self._keys[key_id] = out
        if dbits is not None:
            self._key_digits[key_id] = dbits
        for k in [k for k in self._sched_cache if k[0] == key_id]:
            del self._sched_cache[k]

    def has_keys(self, key_id: str) -> bool:
        return key_id in self._keys

    # ------------------------------------------------------------------
    def _auto_tables(self, steps: Tuple[int, ...]):
        """(perm [S, N] int64, neg [S, N] bool) on the device: the
        automorphism X → X^{5^s} of each step, as a gather and a sign."""
        perms, negs = [], []
        for s in steps:
            perm, sgn = self.ctx._automorphism_map(s)
            perms.append(perm)
            negs.append(sgn < 0)
        return (torch.from_numpy(np.stack(perms)).to(self.device),
                torch.from_numpy(np.stack(negs)).to(self.device))

    def _schedule(self, key_id: str, steps: Tuple[int, ...], lvl: int):
        """A rotation schedule at level ``lvl``: (kb, ka [S, lvl·n_digits,
        lvl+1, N] int32 — each key's rows for the active primes and the
        special prime —, perm, neg [S, N], digit bits), None for no steps.
        Raises for a step without a key. Cached per key_id."""
        if not steps:
            return None
        gks = self._keys[key_id]
        for s in steps:
            if s not in gks:
                raise ValueError(f"missing Galois key for step {s}")
        ckey = (key_id, steps, lvl)
        if ckey not in self._sched_cache:
            with stage("key schedules (once per key)"):
                dbits = self._key_digits[key_id]
                n_comp = lvl * -(-30 // dbits)
                rows = list(range(lvl)) + [self.L]
                kb = torch.stack([gks[s][0][:n_comp, rows] for s in steps])
                ka = torch.stack([gks[s][1][:n_comp, rows] for s in steps])
                self._sched_cache[ckey] = (kb, ka,
                                           *self._auto_tables(steps), dbits)
        return self._sched_cache[ckey]

    def _mask_ntt(self, d: int, window: int, level: int) -> torch.Tensor:
        """[level, N] int64: the slot mask (1 at slot offsets < W mod d),
        encoded at 2^MASK_SCALE_BITS, NTT'd on the host per active prime,
        in four-step order."""
        key = (d, window, level)
        if key not in self._mask_cache:
            with stage("key schedules (once per key)"):
                self._mask_cache[key] = self._build_mask_ntt(d, window, level)
        return self._mask_cache[key]

    def _build_mask_ntt(self, d: int, window: int, level: int):
        mask_slots = np.zeros(self.params.n // 2, np.float64)
        for w in range(window):
            mask_slots[w::d] = 1.0
        coeffs = self.ctx.encode(mask_slots, scale=MASK_SCALE)
        m = np.stack([host_ntt(coeffs % self.ext[i], self.ctx.tables[i])
                      [self._four_perm] for i in range(level)])
        return torch.from_numpy(m).to(self.device)

    def _enc_mat_dev(self) -> torch.Tensor:
        """Parked [N/2, N] f32 real-encode matrix × ctx.scale (a power of
        two — the f32 multiply is exact). Built once (134 MB at N=8192)."""
        if self._enc_mat is None:
            self._enc_mat = torch.from_numpy(
                self.ctx.encode_matrix_real() * np.float32(self.ctx.scale)
            ).to(self.device)
        return self._enc_mat

    # ------------------------------------------------------------------
    # the device program, as plain functions on tensors
    def _qcol(self, lvl: int, device) -> torch.Tensor:
        return torch.tensor(self.ext[:lvl], dtype=torch.int64,
                            device=device)[:, None]

    def _rot_add(self, x0, x1, y0, y1, sched, r: int):
        """(x + rot_r(y)) over [M, l, N] int64 canonical residues: the
        automorphism of step r of the schedule (a gather, negated where
        its sign is −1) on both halves of y, the key switch of the rotated
        c1, the sums mod each prime."""
        kb, ka, perms, negs, dbits = sched
        lvl = x0.shape[1]
        qs = self._qcol(lvl, x0.device)
        perm, neg = perms[r], negs[r]
        v0, v1 = y0[:, :, perm], y1[:, :, perm]
        c0g = torch.where(neg & (v0 != 0), qs - v0, v0)
        c1g = torch.where(neg & (v1 != 0), qs - v1, v1)
        tabs = self._tables[:lvl] + [self._tables[-1]]
        ks0, ks1 = key_switch(c1g, kb[r], ka[r], tabs, dbits)
        return (x0 + c0g + ks0) % qs, (x1 + ks1) % qs

    def _rescale(self, p0: List[torch.Tensor], p1: List[torch.Tensor]):
        """Exact RNS rescale of [M, N] residue rows per prime: drop the last
        prime, dividing by it → (c0, c1) [M, len−1, N] int64."""
        l = len(p0) - 1
        ql = self.ext[l]
        c0, c1 = [], []
        for i in range(l):
            q = self.ext[i]
            inv = pow(ql % q, -1, q)
            c0.append((p0[i] - p0[l]) % q * inv % q)
            c1.append((p1[i] - p1[l]) % q * inv % q)
        return torch.stack(c0, 1), torch.stack(c1, 1)

    def _score_core(self, ct: torch.Tensor, pt_rns: torch.Tensor, pre):
        """ct [nq, 2, L_in, N] coefficient-domain residues (one ct a
        query), pt_rns [nq·blocks, L_in, N] query-major plaintext residues
        → (acc0, acc1) [nq·blocks, L_in−1, N] int64: ct×pt per input prime
        (one forward K2 over the 2·nq ct rows and the plaintext rows, one
        inverse K2 of both products), the exact rescale, then the
        rotate-accumulate of the schedule ``pre``."""
        nq, _, level_in, n = ct.shape
        B = pt_rns.shape[0]
        blocks = B // nq
        prod0, prod1 = [], []
        for i in range(level_in):
            tb = self._tables[i]
            rows = torch.cat([ct[:, 0, i].long(), ct[:, 1, i].long(),
                              pt_rns[:, i].long()])
            nt = ntt4(rows, tb)
            ptn = nt[2 * nq:]
            m0 = modmul(nt[:nq].repeat_interleave(blocks, 0), ptn, tb.q)
            m1 = modmul(nt[nq:2 * nq].repeat_interleave(blocks, 0), ptn, tb.q)
            i01 = intt4(torch.cat([m0, m1]), tb).long()
            prod0.append(i01[:B])
            prod1.append(i01[B:])
        acc0, acc1 = self._rescale(prod0, prod1)
        for r in range(len(pre[2]) if pre else 0):
            acc0, acc1 = self._rot_add(acc0, acc1, acc0, acc1, pre, r)
        return acc0, acc1

    def _score(self, ct, pt_rns, pre) -> torch.Tensor:
        """The per-block program → [nq·blocks, 2, L_in−1, N] int32."""
        acc0, acc1 = self._score_core(ct, pt_rns, pre)
        return torch.stack([acc0, acc1], 1).to(torch.int32)

    def _score_combined(self, ct, pt_coeffs, pre, mask_ntt, tree, post):
        """The combined program (CKKSComputeService.encrypted_scores_combined
        is its host oracle): ct [nq, 2, L_in, N], pt_coeffs [nq·blocks, N]
        SIGNED encode coefficients (reduced per prime here), the schedules
        of the pre-combine, tree and post-combine rotations and the mask's
        NTT → [nq, 2, L_in−2, N] int32, one ciphertext a query.

        The WINDOWED layout: only the IP strides ≥ W = d/n_blocks run
        before the combine; the mask-mult keeps each block's W-slot window
        (ct×pt + exact rescale → one fewer limb); the tree combines the
        blocks with rotations by −W·2^k so block b's window lands at
        [j·d + W·b); the strides < W then finish the inner products on ONE
        row a query."""
        nq, _, level_in, n = ct.shape
        pt_rns = torch.stack([pt_coeffs % q for q in self.ext[:level_in]], 1)
        acc0, acc1 = self._score_core(ct, pt_rns, pre)
        B, level, _ = acc0.shape
        blocks = B // nq
        m0, m1 = [], []
        for i in range(level):
            tb = self._tables[i]
            nt = ntt4(torch.cat([acc0[:, i], acc1[:, i]]), tb)
            cc = intt4(modmul(nt, mask_ntt[i], tb.q), tb).long()
            m0.append(cc[:B])
            m1.append(cc[B:])
        del acc0, acc1
        c0, c1 = self._rescale(m0, m1)                 # [B, lvl2, N]
        lvl2 = level - 1
        cur0 = c0.reshape(nq, blocks, lvl2, n)
        cur1 = c1.reshape(nq, blocks, lvl2, n)
        for k in range(len(tree[2]) if tree else 0):
            nb_k = cur0.shape[1]
            x0, x1 = self._rot_add(
                cur0[:, 0::2].reshape(-1, lvl2, n),
                cur1[:, 0::2].reshape(-1, lvl2, n),
                cur0[:, 1::2].reshape(-1, lvl2, n),
                cur1[:, 1::2].reshape(-1, lvl2, n), tree, k)
            cur0 = x0.reshape(nq, nb_k // 2, lvl2, n)
            cur1 = x1.reshape(nq, nb_k // 2, lvl2, n)
        a0, a1 = cur0[:, 0], cur1[:, 0]
        for r in range(len(post[2]) if post else 0):
            a0, a1 = self._rot_add(a0, a1, a0, a1, post, r)
        return torch.stack([a0, a1], 1).to(torch.int32)

    def _gather(self, ids: torch.Tensor):
        """Parked-base mode: ids [nq, Ppad] (pad id = nbase, the zero row)
        → (slot_rows [nq·blocks, per_ct·d] f32 scaled by 2^-16, norms
        [nq, Ppad] int64 from the same rows: integer-valued f32, so the
        rounded int32 squares are exact)."""
        rows = self._base_dev[ids.long()]              # [nq, Ppad, d]
        nq, p_pad, d = rows.shape
        per_ct = (self.params.n // 2) // d
        slot_rows = (rows * np.float32(1.0 / CAND_SCALE)).reshape(
            nq * (p_pad // per_ct), per_ct * d)
        norms = (torch.round(rows).to(torch.int32) ** 2).sum(-1)
        return slot_rows, norms

    def _encode(self, slot_rows: torch.Tensor) -> torch.Tensor:
        """The candidate encode on the device: slot_rows [B, N/2] f32 (the
        candidates already scaled by 2^-16) @ the [N/2, N] f32 encode matrix
        pre-scaled by Δ, rounded → [B, N] int32 signed coefficients."""
        return torch.round(slot_rows @ self._enc_mat_dev()).to(torch.int32)

    def _seeded_ct(self, c0: torch.Tensor, seeds: torch.Tensor):
        """The seedTf entry: c0 [nq, L_in, N] and the 8-byte threefry keys
        [nq, 2] → ct [nq, 2, L_in, N] int64, the c1 mask regenerated on the
        device (ops/threefry.py)."""
        a = tf_uniform_rns(seeds, self.ext[:c0.shape[1]], self.params.n)
        return torch.stack([c0.long(), a], 1)

    # ------------------------------------------------------------------
    def encrypted_scores(
        self, ct: CKKSCiphertext, candidates: np.ndarray, key_id: str
    ):
        """Enc(⟨q, x_j⟩) for every candidate row; returns
        ([n_blocks] result CKKSCiphertexts, norms [P]) — wire-compatible
        with CKKSComputeService.encrypted_scores."""
        res, norms = self.encrypted_scores_batch(
            [ct], np.asarray(candidates)[None], key_id)
        return res[0], norms[0]

    def encrypted_scores_batch(self, cts: List[CKKSCiphertext],
                               candidates: np.ndarray, key_id: str):
        return self.encrypted_scores_batch_async(cts, candidates, key_id)()

    def _check_keys(self, key_id: str):
        if key_id not in self._keys:
            raise ValueError("unknown CKKS keyId — register Galois keys "
                             "first")

    def _level_in(self, levels: List[int]) -> int:
        level_in = levels[0]
        if any(lv != level_in for lv in levels):
            raise ValueError("query ciphertexts at different levels")
        if not 2 <= level_in <= self.L:
            raise ValueError(f"query ct level {level_in} outside 2..{self.L}")
        return level_in

    def _check_cts(self, cts: List[CKKSCiphertext]) -> int:
        """The common level of full query ciphertexts, each [level, N]."""
        level_in = self._level_in([c.level for c in cts])
        shape = (level_in, self.params.n)
        if any(c.c0.shape != shape or c.c1.shape != shape for c in cts):
            raise ValueError(f"query ciphertexts must be {list(shape)}")
        return level_in

    def encrypted_scores_batch_async(
        self,
        cts: List[CKKSCiphertext],       # [nq] encrypted queries
        candidates: np.ndarray,          # [nq, P, d]
        key_id: str,
    ):
        """Per-block scoring of nq queries in ONE device program: all
        (query, block) plaintexts share each per-prime transform. Returns a
        zero-arg resolver → ([nq][n_blocks] result cts at level L_in−1,
        norms [nq, P]); ``resolver.dev_out`` is the device result
        [nq·n_blocks, 2, L_in−1, N] int32, not yet downloaded."""
        self._check_keys(key_id)
        ctx = self.ctx
        candidates = np.asarray(candidates, np.float64)
        nq, P, d = candidates.shape
        per_ct = (self.params.n // 2) // d
        n_blocks = -(-P // per_ct)
        level_in = self._check_cts(cts)
        pre = self._schedule(key_id, tuple(rotation_steps(d)), level_in - 1)
        with stage("encode (host FFT)"):
            padded = np.zeros((nq, n_blocks * per_ct, d), np.float64)
            padded[:, :P] = candidates
            coeffs = ctx.encode(padded.reshape(nq * n_blocks, per_ct * d))
            qs_in = np.array(self.ext[:level_in], np.int64)
            pt_rns = np.mod(coeffs[:, None, :], qs_in[None, :, None]
                            ).astype(np.int32)          # [nq·blocks, L_in, N]
            ctq = np.stack([np.stack([c.c0, c.c1]) for c in cts]
                           ).astype(np.int32)            # [nq, 2, L_in, N]
            norms = (np.round(candidates).astype(np.int64) ** 2).sum(-1)
        with stage("upload"):
            ct_d = torch.from_numpy(ctq).to(self.device)
            pt_d = torch.from_numpy(pt_rns).to(self.device)
        with stage("device program"):
            dev_out = self._score(ct_d, pt_d, pre)
        out_scale = cts[0].scale * ctx.scale / self.ext[level_in - 1]

        def resolve():
            with stage("download"):
                out = dev_out.cpu().numpy().astype(np.int64)
            result = [[CKKSCiphertext(c0=out[qi * n_blocks + b, 0],
                                      c1=out[qi * n_blocks + b, 1],
                                      level=level_in - 1, scale=out_scale)
                       for b in range(n_blocks)] for qi in range(nq)]
            return result, norms

        resolve.dev_out = dev_out
        return resolve

    def encrypted_scores_combined_batch(self, cts, candidates, key_id: str,
                                        dev_encode: bool = False):
        return self.encrypted_scores_combined_batch_async(
            cts, candidates, key_id, dev_encode)()

    def _combined_layout(self, P: int, d: int):
        """(per_ct, n_blocks padded to a power of two, window W)."""
        per_ct = (self.params.n // 2) // d
        n_blocks = -(-P // per_ct)
        if n_blocks > 1:
            n_blocks = 1 << (n_blocks - 1).bit_length()     # pow2 tree
        if n_blocks > d:
            raise ValueError("combine needs n_blocks <= d distinct offsets")
        return per_ct, n_blocks, combine_window(d, n_blocks)

    def encrypted_scores_combined_batch_async(
        self,
        cts: list,                       # [nq] level-3 cts or ct wires
        candidates: np.ndarray,          # [nq, P, d] rows or [nq, P] ids
        key_id: str,
        dev_encode: bool = False,
    ):
        """Combined single-ct response: device twin of
        CKKSComputeService.encrypted_scores_combined. ONE level-(L_in−2)
        result ct per query. Needs Galois keys for the IP-tree steps AND
        the combine steps −W·2^k (crypto/ckks.combine_tree_steps).

        ``cts``: CKKSCiphertexts or ct wires; when every wire is a seedTf
        one, only c0 and the 8-byte keys are uploaded and c1 is made on the
        device. ``candidates``: integer ids [nq, P] into the parked base
        (``set_base``; gather, norms and encode in the device program), or
        rows [nq, P, d] encoded on the host (``dev_encode=False``, the
        host FFT) or on the device (``dev_encode=True``, the f32 matmul on
        uploaded slot rows).

        Returns a resolver → ([nq] CKKSCiphertext, norms [nq, P]);
        ``resolver.dev_out`` is the device result [nq, 2, L_in−2, N];
        ``resolver.program_repeat()`` runs the device work again on the
        same uploaded inputs."""
        self._check_keys(key_id)
        ctx = self.ctx
        n = self.params.n
        seed_mode = all(isinstance(c, dict) and "seedTf" in c for c in cts)
        if not seed_mode:
            with stage("ct_from_wire"):
                cts = [ctx.ct_from_wire(c) if isinstance(c, dict) else c
                       for c in cts]
        candidates = np.asarray(candidates)
        gather = (candidates.ndim == 2
                  and np.issubdtype(candidates.dtype, np.integer))
        if gather:
            if self._base_dev is None:
                raise ValueError("index candidates need set_base() first")
            nq, P = candidates.shape
            d = int(self._base_dev.shape[1])
        else:
            nq, P, d = candidates.shape
        if len(cts) != nq:
            raise ValueError(f"{len(cts)} query ciphertexts for {nq} "
                             f"candidate rows")
        per_ct, n_blocks, window = self._combined_layout(P, d)
        n_tree = (n_blocks - 1).bit_length() if n_blocks > 1 else 0
        steps = rotation_steps(d)
        level_in = (self._level_in([int(c["level"]) for c in cts])
                    if seed_mode else self._check_cts(cts))
        if level_in < 3:
            raise ValueError("combined scoring needs a level-3 query ct")
        level = level_in - 1
        pre = self._schedule(key_id, tuple(s for s in steps if s >= window),
                             level)
        tree = self._schedule(
            key_id, tuple(-(window << k) for k in range(n_tree)), level - 1)
        post = self._schedule(key_id, tuple(s for s in steps if s < window),
                              level - 1)
        mask_ntt = self._mask_ntt(d, window, level)

        if seed_mode:
            with stage("wire decode (c0 + seeds)"):
                seeds = [c["seedTf"] for c in cts]
                if not all(isinstance(s, (list, tuple)) and len(s) == 2
                           and all(type(v) is int and 0 <= v < 1 << 32
                                   for v in s) for s in seeds):
                    raise ValueError("seedTf must be two uint32 words a "
                                     "query")
                c0s = np.stack([
                    np.frombuffer(base64.b64decode(c["c0"]), "<u4")
                    .reshape(level_in, n) for c in cts]).astype(np.int32)
                lead = (c0s, np.array(seeds, np.int64))
            scale_in = float(cts[0]["scale"])
        else:
            lead = (np.stack([np.stack([c.c0, c.c1]) for c in cts]
                             ).astype(np.int32),)
            scale_in = cts[0].scale
        if gather:
            p_pad = n_blocks * per_ct
            ids_pad = np.full((nq, p_pad), self._base_dev.shape[0] - 1,
                              np.int32)             # pad id → the zero row
            ids_pad[:, :P] = candidates
            pt_host = ids_pad
        else:
            padded = np.zeros((nq, n_blocks * per_ct, d), np.float64)
            padded[:, :P] = candidates
            norms = (np.round(candidates).astype(np.int64) ** 2).sum(-1)
            flat = padded.reshape(nq * n_blocks, per_ct * d)
            if dev_encode:
                # |coeff| ≤ scale·max|slot|: 16·2^26 = 2^30 keeps a full
                # power of two of headroom below int32 for the f32 sum's
                # rounding before the cast
                if np.abs(padded).max() >= 16.0 * CAND_SCALE:
                    raise ValueError("combined pt coeffs overflow")
                pt_host = (flat * (1.0 / CAND_SCALE)).astype(np.float32)
            else:
                with stage("encode (host FFT)"):
                    coeffs = ctx.encode(flat / CAND_SCALE)
                if np.abs(coeffs).max() >= 1 << 31:
                    raise ValueError("combined pt coeffs overflow")
                pt_host = coeffs.astype(np.int32)
        with stage("upload"):
            lead_d = [torch.from_numpy(x).to(self.device) for x in lead]
            pt_d = torch.from_numpy(pt_host).to(self.device)
        norms_dev = None
        pt_in = pt_d
        if gather or dev_encode:
            with stage("gather and encode"):
                if gather:
                    slot_rows, norms_dev = self._gather(pt_d)
                else:
                    slot_rows = pt_d
                pt_d = self._encode(slot_rows)
        with stage("device program"):
            ct_d = self._seeded_ct(*lead_d) if seed_mode else lead_d[0]
            dev_out = self._score_combined(ct_d, pt_d, pre, mask_ntt, tree,
                                           post)

        def program_repeat():
            """The device work again (gather, encode, program) on the
            same uploaded inputs: no host work, no upload."""
            pt = pt_in
            if gather or dev_encode:
                pt = self._encode(self._gather(pt)[0] if gather else pt)
            ct = self._seeded_ct(*lead_d) if seed_mode else lead_d[0]
            return self._score_combined(ct, pt, pre, mask_ntt, tree, post)

        scale1 = scale_in * ctx.scale / self.ext[level_in - 1]
        scale2 = scale1 * MASK_SCALE / self.ext[level - 1]
        out_scale = scale2 / CAND_SCALE

        def resolve():
            with stage("download"):
                out = dev_out.cpu().numpy().astype(np.int64)
                nrm = (norms if norms_dev is None
                       else norms_dev[:, :P].cpu().numpy().astype(np.int64))
            result = [CKKSCiphertext(c0=out[qi, 0], c1=out[qi, 1],
                                     level=level - 1, scale=out_scale)
                      for qi in range(nq)]
            return result, nrm

        resolve.dev_out = dev_out
        resolve.program_repeat = program_repeat
        return resolve
