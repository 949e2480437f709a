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
of kernel K2 (ops/ntt4_fused.py), and the rotation step's modular
arithmetic around K2 three hand-written kernels (ops/key_switch.py). The
rest of the device program is eager PyTorch on int32/int64 tensors: CUDA
has native 64-bit integer multiply and remainder, so every step is exact
and the result is bit-equal to the JAX program's.

``device`` takes the place of the JAX service's ``backend``: on a card the
program runs there with K2; with ``device="cpu"`` the same program runs on
CPU tensors, where K2's wrapper takes its plain version. The numpy host
twins (``_trunc_mac_numpy``, ``_trunc_mac_q1_numpy``, ``_packed_mac_numpy``,
``_mac_numpy``: the host NTT, natural order) are the independent oracle
the tests hold the program against; no served path falls back to them.

``encrypted_scores_batch`` and ``encrypted_scores`` return the whole
result ciphertexts of the same MAC (one K2 launch a limb; host twin
``_mac_numpy``); no route of either package serves them.

``CKKSComputeService`` (numpy) is the host twin and oracle of the CKKS
device program (engine/ckks_device.py).

The Galois machinery of the three HE device programs (the packed program
here, engine/ckks_device.py and engine/pir_device.py) is written once
here: the key intake (``check_galois_keys``, ``galois_key_tables``), the
automorphism tables (``automorphism_tables``) and the rotation step
(``rotate_add``, over ``key_switch`` and the kernels of
ops/key_switch.py), bundled per key set as ``Rotations``.
"""

from __future__ import annotations

import base64
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.crypto.bfv import BFVContext, Ciphertext, RelinKey
from prefhetch_tpu_torch.crypto.ckks import (
    CKKSContext, GaloisKey, combine_window, rotation_steps,
)
from prefhetch_tpu_torch.crypto.ntt import build_tables, intt, ntt
from prefhetch_tpu_torch.crypto.packing import candidates_per_block, plain_ints
from prefhetch_tpu_torch.crypto.params import BFVParams
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.ops.key_switch import ks_digits, ks_finish, ks_mac
from prefhetch_tpu_torch.ops.ntt4 import (
    build_ntt4_tables, fourstep_perm, intt4, modmul, ntt4,
)
from prefhetch_tpu_torch.ops.threefry import tf_uniform_rns
from prefhetch_tpu_torch.utils.stages import stage


def key_switch(y1: torch.Tensor, perm: torch.Tensor, neg: torch.Tensor,
               kb: torch.Tensor, ka: torch.Tensor, tabs,
               digit_bits: int) -> List[torch.Tensor]:
    """Hybrid key switch of σ(y1) on the device, σ the signed automorphism
    (perm, neg): the switch of ``rotate_add``, the rotation step of the
    packed BFV program, the CKKS program (engine/ckks_device.py, at its
    active level) and the PIR expansion (engine/pir_device.py).

    y1 [M, l, N]: canonical residues mod the first l primes of ``tabs``;
    kb, ka [l·n_digits, l+1, N] int32: the key's rows for those primes and
    the special prime (the last of ``tabs``), NTT domain in four-step
    order → per prime of ``tabs``, the inverse transform [2M, N] int32 of
    both halves' sums (the kb half in rows [0, M)), which
    ``ops.key_switch.ks_finish`` divides by the special prime.

    The digit planes of σ(y1) (``ks_digits``); per extension prime one
    forward K2 over all (row, digit) polys, the n_comp products with the
    key summed in registers (``ks_mac``), one inverse K2 of both halves.
    One prime's transformed digits live at a time; the digits go before
    the last prime's sums."""
    l = len(tabs) - 1
    flat = ks_digits(y1, perm, neg, [tb.q for tb in tabs[:l]], digit_bits)
    parts = []
    for e, tb in enumerate(tabs):
        d = ntt4(flat, tb)
        if e == l:
            del flat
        s01 = ks_mac(d, kb[:, e], ka[:, e], tb.q)
        del d
        parts.append(intt4(s01, tb))
        del s01
    return parts


class Rotations(NamedTuple):
    """A sequence of Galois rotations on the device; round r reads row r
    of kb, ka, perm and neg.

    kb, ka [R, n_comp, l+1, N] int32: the keys' rows for the l active
    primes and the special prime, NTT domain in four-step order
    (``galois_key_tables``); perm [R, N] int64, neg [R, N] bool: the
    automorphisms (``automorphism_tables``); tabs: the K2 tables of those
    l+1 primes; digit_bits: the keys' digit width."""

    kb: torch.Tensor
    ka: torch.Tensor
    perm: torch.Tensor
    neg: torch.Tensor
    tabs: list
    digit_bits: int


def check_galois_keys(keys: dict, tabs) -> "int | None":
    """The refusals of a Galois key set {name: RelinKey | GaloisKey} over
    the extension basis of ``tabs`` (L primes and the special prime, last):
    each key's basis, its shape [n_comp, L+1, N], and one digit width for
    the set with n_comp = L·⌈30/digit_bits⌉. Returns the width (None for
    an empty set)."""
    ext = tuple(tb.q for tb in tabs)
    L, n = len(ext) - 1, tabs[0].n
    bits = None
    for name, key in keys.items():
        # a CKKS GaloisKey names no basis: its rows are its context's
        basis = getattr(key, "ext", None)
        if basis is not None and (tuple(basis) != ext
                                  or key.special_p != ext[-1]):
            raise ValueError(
                f"galois key {name}: basis {tuple(basis)} / special prime "
                f"{key.special_p} does not match the service's {ext}")
        if key.b.shape[1:] != (L + 1, n) or key.a.shape != key.b.shape:
            raise ValueError(
                f"galois key {name}: shape {key.b.shape} does not match the "
                f"service's {L + 1} primes of N={n}")
        kbits = int(key.digit_bits)
        if kbits < 1 or key.b.shape[0] != L * -(-30 // kbits):
            raise ValueError(
                f"galois key {name}: digitBits {key.digit_bits} / shape "
                f"{key.b.shape} inconsistent with {L} limbs")
        if bits not in (None, kbits):
            raise ValueError(
                f"galois key {name}: digitBits {kbits} inconsistent with "
                f"digitBits {bits} of the other keys")
        bits = kbits
    return bits


def galois_key_tables(keys: dict, tabs, device):
    """A Galois key set {name: key} (``check_galois_keys``) on the device:
    every component host-NTT'd per prime of ``tabs`` into four-step order →
    (kb, ka [len(keys), n_comp, L+1, N] int32, digit_bits)."""
    bits = check_galois_keys(keys, tabs)
    perm = fourstep_perm(tabs[0])[0]
    host = [build_tables(tb.q, tb.n) for tb in tabs]
    first = next(iter(keys.values()))
    kb = np.empty((len(keys),) + first.b.shape, np.int32)
    ka = np.empty_like(kb)
    for j, key in enumerate(keys.values()):
        for e, tb in enumerate(host):
            kb[j, :, e] = ntt(key.b[:, e] % tb.q, tb)[:, perm]
            ka[j, :, e] = ntt(key.a[:, e] % tb.q, tb)[:, perm]
    return (torch.from_numpy(kb).to(device), torch.from_numpy(ka).to(device),
            bits)


def automorphism_tables(ctx, elts, device):
    """(perm [S, N] int64, neg [S, N] bool) on the device: the automorphism
    of each element of ``elts`` as ``ctx._automorphism_map`` gives it, a
    gather and a sign."""
    maps = [ctx._automorphism_map(g) for g in elts]
    return (torch.from_numpy(np.stack([pm for pm, _ in maps])).to(device),
            torch.from_numpy(np.stack([sg < 0 for _, sg in maps])).to(device))


def rotate_add(x0, x1, y0, y1, rot: Rotations, r: int):
    """(x0, x1) + σ(y0, y1) mod q with σ round r of ``rot``: σ(y1)
    key-switched (``key_switch``), then ``ks_finish`` adds x0 + σ(y0) and
    x1 to the switch's halves. x, y [..., l, N] canonical residues mod the
    first l primes of ``rot.tabs``, in one storage dtype (int32 or int64) →
    the sums in x's shape and dtype. Neither σ(y1) nor σ(y0) is
    materialised: the digits and the finish gather through the
    automorphism as they read; the digit planes are freed before σ(y0) is
    read. A round is l + 3 launches of ``ops/key_switch.py``'s kernels
    around K2's 2(l + 1) on the card."""
    perm, neg = rot.perm[r], rot.neg[r]
    shape = x0.shape
    l, n = shape[-2:]

    def rows(t):
        return t.reshape(-1, l, n).contiguous()

    parts = key_switch(rows(y1), perm, neg, rot.kb[r], rot.ka[r], rot.tabs,
                       rot.digit_bits)
    z0, z1 = ks_finish(parts, rows(x0), rows(x1), rows(y0), perm, neg,
                       [tb.q for tb in rot.tabs[:l]], rot.tabs[-1].q)
    return z0.view(shape), z1.view(shape)


class HEComputeService:
    """Holds a BFV parameter context (no keys) + the batched MAC program."""

    def __init__(self, params: BFVParams,
                 device: "str | torch.device" = "cuda"):
        self.params = params
        self.ctx = BFVContext(params)
        self.device = resolve_device(device)
        # the L primes and the special prime of the packed key switch
        self._ext_tables = [build_ntt4_tables(q, params.n) for q in
                            tuple(params.qs) + (self.ctx._special_p,)]
        self._tables = self._ext_tables[:len(params.qs)]
        perm, inv_perm = fourstep_perm(self._tables[0])
        self._four_perm = perm
        self._perm = torch.from_numpy(perm).to(self.device)
        self._inv_perm = torch.from_numpy(inv_perm).to(self.device)
        self._base_host: np.ndarray | None = None
        self._base_dev: torch.Tensor | None = None
        self._galois_bfv: Dict[str, Dict[int, RelinKey]] = {}
        self._packed_keys_dev: Dict[str, Rotations] = {}
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

    def _mac_limbs(self, c0q: torch.Tensor, c1q: torch.Tensor,
                   rows: torch.Tensor, mono_pre: torch.Tensor | None = None):
        """The ct×pt MAC of every response wire. Yields, per limb,
        (tables, o0, o1): the c0 and c1 products [nq, nb, N] int64 in
        four-step NTT order.

        c0q, c1q [nq, L, N]: the query ciphertext in four-step NTT order;
        the candidate rows [nq, npad, d] int32 (B rows a block) are each
        REVERSED in their d-aligned window, and negatives are lifted per
        limb before the forward transform; the packed program's mono_pre
        [L, N] multiplies the transformed rows first."""
        n = self.params.n
        nq, npad, d = rows.shape
        nb = npad * d // n
        polys = rows.flip(-1).reshape(nq * nb, n)
        for i, tb in enumerate(self._tables):
            q = tb.q
            lifted = torch.where(polys < 0, polys + q, polys)
            pt = ntt4(lifted, tb).reshape(nq, nb, n)
            if mono_pre is not None:
                pt = modmul(pt, mono_pre[i], q)
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
        for tb, o0, o1 in self._mac_limbs(*ctq[..., self._perm].unbind(1),
                                          rows):
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
        for tb, o0, o1 in self._mac_limbs(*ctq[..., self._perm].unbind(1),
                                          rows):
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
        """Host twin of ``_mac_limbs`` (host NTT, natural order):
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
        return (self._stack_cts(cts),) + self._pad_and_norms(cand_idx)

    def _stack_cts(self, cts: List[Ciphertext]) -> np.ndarray:
        """Query ciphertexts → ctq [nq, 2, L, N] i32, natural-order NTT
        (a coefficient-domain ct is transformed on the host)."""
        cts = [self.ctx.to_ntt(c) if not c.is_ntt else c for c in cts]
        return np.stack(
            [np.stack([c.c0 for c in cts]), np.stack([c.c1 for c in cts])],
            axis=1,
        ).astype(np.int32)

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

    # -- whole result ciphertexts -------------------------------------------
    # Enc(⟨q, x⟩) per candidate block as a whole 2-limb NTT-domain
    # ciphertext: the MAC of the response wires without their truncation.
    # No route serves it (in either package); the service and the client
    # (HEClient.decrypt_scores(_batch)) are called directly.

    def encrypted_scores_batch(
        self,
        cts: List[Ciphertext],        # [nq] encrypted queries
        candidates: np.ndarray,       # [nq, P, d] integer-valued vectors
    ) -> Tuple[List[List[Ciphertext]], np.ndarray]:
        """Batched MACs on the service's device: one forward transform (one
        K2 launch) a limb over all (query, block) plaintexts. Returns
        ([nq][n_blocks] result cts, natural-order NTT, int32 residues;
        squared norms [nq, P] i64)."""
        nq, P, d = candidates.shape
        B = candidates_per_block(self.params, d)
        nb = -(-P // B)
        with stage("pack (stack, check, pad, norms)"):
            ctq = self._stack_cts(cts)
            rows = np.zeros((nq, nb * B, d), np.int32)
            rows[:, :P] = plain_ints(candidates, self.params.t, "candidates")
            norms = (rows[:, :P].astype(np.int64) ** 2).sum(-1)
        ctq_d, rows_d = self.upload(ctq, rows)
        with stage("device program"):
            out = self._whole_mac(ctq_d, rows_d)
        with stage("download"):
            host = out.cpu().numpy()
        return [[Ciphertext(c0=host[qi, b, 0], c1=host[qi, b, 1], is_ntt=True)
                 for b in range(nb)] for qi in range(nq)], norms

    def encrypted_scores(
        self, ct: Ciphertext, candidates: np.ndarray,   # [P, d]
    ) -> Tuple[List[Ciphertext], np.ndarray]:
        """One query's ``encrypted_scores_batch``: (result cts a block,
        squared norms [P])."""
        blocks, norms = self.encrypted_scores_batch([ct], candidates[None])
        return blocks[0], norms[0]

    def _whole_mac(self, ctq: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """(ctq [nq, 2, L, N] i32 natural-order NTT, rows [nq, nb·B, d] i32)
        → [nq, nb, 2, L, N] i32: (c0, c1) of every result ciphertext,
        natural-order NTT (the four-step products permuted back)."""
        out = [torch.stack([o0, o1], 2)[..., self._inv_perm]
               for _, o0, o1 in self._mac_limbs(
                   *ctq[..., self._perm].unbind(1), rows)]
        return torch.stack(out, 3).to(torch.int32)

    def _mac_numpy(self, c0, c1, pt_polys):
        """Host twin of the whole-ciphertext MAC: (c0, c1 [L, N] NTT domain,
        pt_polys [B, N] packed signed ints, crypto/packing.pack_candidates)
        → ([B, L, N], [B, L, N]) int64."""
        outs0, outs1 = [], []
        for i, tb in enumerate(self.ctx.tables):
            q = tb.q
            pt_ntt = ntt(pt_polys % q, tb)              # [B, N]
            outs0.append(c0[i][None, :].astype(np.int64) * pt_ntt % q)
            outs1.append(c1[i][None, :].astype(np.int64) * pt_ntt % q)
        return np.stack(outs0, axis=1), np.stack(outs1, axis=1)

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
        check_galois_keys(keys, self._ext_tables)
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
        [n_out, 2, L, N] int32; ``resolver.program_repeat()`` runs the
        device program again on the same uploaded inputs."""
        nb, G = self._packed_layout(key_id, len(cts), cand_idx)
        ctq, pad_idx, norms = self.prepare(cts, cand_idx)
        ctq_d, idx_d = self.upload(ctq, pad_idx)
        args = self._packed_args(key_id, nb, G)

        def program():
            return self._packed_program(*ctq_d[..., self._perm].unbind(1),
                                        idx_d, *args)

        with stage("device program"):
            out = program()
        return self._packed_resolver(out, norms, G, program)

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

        def program():
            return self._packed_seeded(c0_d, seeds_d, idx_d, *args)

        with stage("device program"):
            out = program()
        return self._packed_resolver(out, norms, G, program)

    @staticmethod
    def _packed_resolver(dev_out: torch.Tensor, norms: np.ndarray, G: int,
                         program):
        def resolve():
            with stage("download"):
                packed = dev_out.cpu().numpy().astype(np.int64)
            return ([Ciphertext(c0=c[0], c1=c[1], is_ntt=False)
                     for c in packed], norms, G)

        resolve.dev_out = dev_out
        resolve.program_repeat = program
        return resolve

    # -- packed response: host oracle --------------------------------------
    def _packed_mac_numpy(
        self, ctq: np.ndarray, pad_idx: np.ndarray, gks: dict
    ) -> np.ndarray:
        """Host twin of the packed program (host NTT, natural order;
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
    def _packed_args(self, key_id: str, nb: int, G: int):
        """The device arguments of the packed program after the queries and
        indices: the extraction rotations and the monomial tables."""
        return (self._packed_rotations(key_id),
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
            pre_e = (2 * n - (d - 1)) % (2 * n)
            shifts = [g * nb + b for g in range(G) for b in range(nb)]

            def mono_rows(es, q, tb):
                rows = np.zeros((len(es), n), np.int64)
                for r, e in enumerate(es):
                    rows[r, e % n] = 1 if e < n else q - 1
                return ntt(rows, tb)[:, self._four_perm]

            pre, sh = [], []
            for q, tb in zip(self.params.qs, self.ctx.tables):
                pre.append(mono_rows([pre_e], q, tb)[0])
                sh.append(mono_rows(shifts, q, tb))
            self._packed_shift_cache[key] = (
                torch.from_numpy(np.stack(pre)).to(self.device),
                torch.from_numpy(np.stack(sh)).to(self.device))
        return self._packed_shift_cache[key]

    def _packed_rotations(self, key_id: str) -> Rotations:
        """The log2(d) extraction rounds of key_id on the device, its keys
        at the digit width they were registered with; cached per key_id."""
        if key_id not in self._packed_keys_dev:
            with stage("galois key tables (host NTT, once per key)"):
                gks = self._galois_bfv[key_id]
                elts = self.ctx.extraction_elts(self.params.n,
                                                self._base_host.shape[1])
                kb, ka, bits = galois_key_tables(
                    {g: gks[g] for g in elts}, self._ext_tables, self.device)
                self._packed_keys_dev[key_id] = Rotations(
                    kb, ka, *automorphism_tables(self.ctx, elts, self.device),
                    self._ext_tables, bits)
        return self._packed_keys_dev[key_id]

    def _packed_program(self, c0q, c1q, idx, rot: Rotations,
                        mono_pre, shift_tabs) -> torch.Tensor:
        """The packed program: (c0q, c1q [nq, L, N] FOUR-STEP NTT domain,
        idx [nq, nb·B] i32, the extraction rotations and the monomial
        tables) → [n_out, 2, L, N] int32 coeff-domain packed response
        ciphertexts.

        1. MAC with the X^{-(d-1)} pre-shift, per limb (``_mac_limbs``): one
           forward K2 of the gathered, reversed, lifted rows, NTT-domain
           multiplies by mono_pre and by c0/c1, one inverse K2 of both
           halves;
        2. log2(d) extraction rounds ct += σ_g(ct) (``rotate_add``): an
           automorphism gather with its sign and a key switch;
        3. the shift-pack, per limb: one forward K2 of both halves, a
           multiply by each row's monomial NTT(X^{(qi mod G)·nb + b}), the
           sum over groups of G·nb rows (< 2^37, exact), one inverse K2.

        Only the nq·nb real rows are computed: absent queries of the last
        group contribute nothing, as the zero ciphertexts they stand for
        would (the JAX program pads the batch to a multiple of G)."""
        n = self.params.n
        nq, npad = idx.shape
        d = self._base_dev.shape[1]
        nb = npad * d // n
        gnb = shift_tabs.shape[1]                    # G·nb
        M = nq * nb
        n_out = -(-M // gnb)
        c0, c1 = [], []
        for tb, o0, o1 in self._mac_limbs(c0q, c1q, self._base_dev[idx.long()],
                                          mono_pre):
            i01 = intt4(torch.cat([o0.reshape(M, n), o1.reshape(M, n)]),
                        tb).to(torch.int64)
            c0.append(i01[:M])
            c1.append(i01[M:])
        c0 = torch.stack(c0, 1)                       # [M, L, N] coeff
        c1 = torch.stack(c1, 1)
        for r in range(len(rot.perm)):
            c0, c1 = rotate_add(c0, c1, c0, c1, rot, r)
        outs = []
        for i, tb in enumerate(self._tables):
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
        a = tf_uniform_rns(seeds, self.params.qs, self.params.n)
        c1q = torch.stack([ntt4(a[:, i], tb)
                           for i, tb in enumerate(self._tables)], 1)
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
