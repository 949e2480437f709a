"""Device-resident 2-D PIR answering — the port of
prefhetch_tpu/engine/pir_device.py ``DevicePIR2``, the device twin of
crypto/pir.py ``PIR2Server`` with the same wire contract.

Per request the host uploads the query ciphertexts (coefficient domain,
one [L, N] pair each) and downloads 2·n_digits single-limb response
ciphertexts a fetched row; the packed database and the client's expansion
keys stay on the device. The answer program, eager PyTorch on int32/int64
tensors, for a chunk of B query ciphertexts at once:

1. breadth-first oblivious expansion to 2^logm selectors a ciphertext:
   logm rounds, each a signed monomial permutation, a signed Galois
   permutation and one key switch (engine/hecompute.py ``key_switch``,
   15-bit digits, shared with the packed BFV and CKKS programs) over every
   ciphertext of the round;
2. one forward transform a limb of every selector that is used;
3. the dim-1 fold C_j = Σ_i sel_i ⊗ db[i, j] over the g1 rows of the
   [g1, g2] hypercube: one pass over the database serves every selector
   set of the chunk (every row of a multi-row ciphertext and every
   ciphertext), products summed seven at a time in int64 between
   reductions; one inverse transform a limb;
4. the RNS modulus switch to q1 (the q2 residue centred first) and the
   base-t digits of the g2 column ciphertexts, one forward transform a limb
   of all 2·n_digits digit planes;
5. the dim-2 fold with the selectors g1..g1+g2, one inverse transform a
   limb of the 2·n_digits sums, and the switch to q1.

Every transform is one call of ``ops/ntt4.ntt4``/``intt4``: one launch of
kernel K2 on the card, its plain version on CPU tensors. A chunk takes
6·logm + 4·L launches: 62 for single-row ciphertexts and 80 for fully
packed multi-row ones at the SIFT1M preset (N=4096, L=2, g1 = g2 = 177).
Modular products are ``%`` on int64, which is exact, so the responses are
bit-equal to the JAX program's and to ``PIR2Server``'s. The NTT domain of
this module is in four-step order: the database (transformed on the device
by K2, which emits that order) and the key stacks (host NTT, then
``fourstep_perm``); the wire stays in the natural coefficient domain.

Not ported: the JAX module's disk caches (``cache_dir``: the transformed
database and key stacks), its serialised TPU executables, its retry and
blacklist of batch sizes after a compile failure, and its XLA batch
buckets. In their place ``MAX_EXPANDED`` caps the ciphertexts one program
takes; a request's ciphertexts run in chunks of at most that many, without
padding, and each response is bit-equal to the one-ciphertext answer.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.crypto.bfv import BFVContext, Ciphertext, RelinKey
from prefhetch_tpu_torch.crypto.ntt import build_tables, ntt as host_ntt
from prefhetch_tpu_torch.crypto.params import BFVParams
from prefhetch_tpu_torch.crypto.pir import grid_dims, pack_database
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.engine.hecompute import key_switch
from prefhetch_tpu_torch.ops.ntt4 import (
    build_ntt4_tables, fourstep_perm, intt4, ntt4,
)
from prefhetch_tpu_torch.utils.stages import stage
from prefhetch_tpu_torch.utils.wire import pack_i32

DIGIT_BITS = 15
N_KS_DIGITS = 2          # 30-bit limbs → two 15-bit key-switch digits

# Expanded selector ciphertexts one program holds at its widest round
# (B query ciphertexts × 2^logm). At N=4096 and L=2 the widest round keeps
# ~0.7 MiB an expanded ciphertext live (its int32 halves, their signed
# permutations, the [4, N] key-switch digits, their int64 products by one
# prime's key and the int64 sums of three primes): 40,960 = ten fully
# packed multi-row ciphertexts (10 × 4,096, the 100-row fetch of one query
# at SIFT1M) peaked at 28.75 GiB above the 1,026.7 MB database on an H100
# 80GB (chip_smoke.py [pir]); 80 single-row ciphertexts (m_pad = 512) take
# the same cap. The frontends answer requests on several threads, and two
# such programs at once would need ~58 GiB, three more than the card holds,
# so a service runs its programs one at a time (``DevicePIR2._lock``) and
# the cap leaves the card half free whatever the concurrency.
MAX_EXPANDED = 40_960

# products < q² < 2^60: seven of them and a residue < q stay below 2^63
_SUMS_PER_REDUCE = 7


class DevicePIR2:
    """Device twin of crypto/pir.PIR2Server (same wire contract), on
    ``device`` (default the card; ``"cpu"`` runs K2's plain version)."""

    def __init__(self, base: np.ndarray, params: BFVParams,
                 device: "str | torch.device" = "cuda"):
        if len(params.qs) != 2:
            raise ValueError("device PIR expects 2 RNS limbs")
        self.params = params
        self.device = resolve_device(device)
        self.ctx = BFVContext(params)
        self.d = base.shape[1]
        self.nbase = base.shape[0]
        _, self.g1, self.g2 = grid_dims(params, self.nbase, self.d)
        self.m = self.g1 + self.g2
        self.logm = max(1, (self.m - 1).bit_length())
        self.m_pad = 1 << self.logm
        self._n_digits = 1
        while (params.t ** self._n_digits) < params.qs[0]:
            self._n_digits += 1
        n, L = params.n, len(params.qs)
        self._tabs_q = [build_ntt4_tables(q, n) for q in params.qs]
        self._fs_perm = fourstep_perm(self._tabs_q[0])[0]
        self._qs = torch.tensor(params.qs, dtype=torch.int64,
                                device=self.device)[:, None]      # [L, 1]
        self._qs32 = self._qs.to(torch.int32)

        with stage("pack_database"):
            polys = pack_database(base, params)                   # [G, N]
        with stage("database upload + transform"):
            x = torch.zeros((self.g1 * self.g2, n), dtype=torch.int32,
                            device=self.device)
            x[: polys.shape[0]] = torch.from_numpy(
                polys.astype(np.int32)).to(self.device)
            del polys
            # one forward K2 a limb; values < t < q need no lift, and the
            # output is already in four-step order
            self.db = torch.stack([ntt4(x, tb) for tb in self._tabs_q],
                                  dim=1).view(self.g1, self.g2, L, n)
            del x

        # per-level monomial/automorphism tables to FULL depth log2(N): the
        # multi-row query expands to n_rows·m selectors, deeper than logm
        self.logm_max = n.bit_length() - 1
        k = np.arange(n)
        mono_perm = np.empty((self.logm_max, n), np.int64)
        mono_neg = np.empty((self.logm_max, n), bool)
        gal_perm = np.empty((self.logm_max, n), np.int64)
        gal_neg = np.empty((self.logm_max, n), bool)
        self._gal_elts: List[int] = []
        for j in range(self.logm_max):
            # out[pos[k]] = sign[k]·in[k]  →  out[i] = sg[i]·in[pm[i]]
            dest = (k + (-(1 << j)) % (2 * n)) % (2 * n)
            mono_perm[j, dest % n] = k
            mono_neg[j, dest % n] = dest >= n
            g = (n >> j) + 1
            self._gal_elts.append(g)
            kg = (k * g) % (2 * n)
            gal_perm[j, kg % n] = k
            gal_neg[j, kg % n] = kg >= n
        self.mono_perm = torch.from_numpy(mono_perm).to(self.device)
        self.mono_neg = torch.from_numpy(mono_neg).to(self.device)
        self.gal_perm = torch.from_numpy(gal_perm).to(self.device)
        self.gal_neg = torch.from_numpy(gal_neg).to(self.device)
        self._ext = tuple(params.qs) + (self.ctx._special_p,)
        self._tabs_ext = [build_ntt4_tables(q, n) for q in self._ext]
        # key_id -> (kb, ka) [depth, n_comp, L+1, N] int32, four-step order
        self._keys: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._key_fps: Dict[str, tuple] = {}
        # one answer program at a time on the device (see MAX_EXPANDED)
        self._lock = threading.Lock()

    @property
    def n_selectors(self) -> int:
        return self.m

    def rows_per_ct(self) -> int:
        """Max row-fetches one packed query ct carries (⌊N/m⌋)."""
        return max(1, self.params.n // self.m)

    def has_keys(self, key_id: str) -> bool:
        return key_id in self._keys

    # ------------------------------------------------------------------
    def register_galois_keys(self, key_id: str, gks_wire: dict) -> None:
        """Host-NTT the key components per extension prime into four-step
        order and stack them per level, on the device.

        Accepts any contiguous prefix of the full log2(N)-level element
        chain (n>>j)+1: single-row clients send logm levels, multi-row
        clients the deeper tree their n_rows·m expansion needs. A shallower
        re-registration of the SAME keys (by fingerprint) keeps the deeper
        stack; different keys under the id overwrite it. Refuses keys the
        device key switch cannot use: digitBits other than 15, or another
        extension basis or special prime than the service's."""
        gks = {int(g): RelinKey.from_wire(w) for g, w in gks_wire.items()}
        wire_by_elt = {int(g): w for g, w in gks_wire.items()}
        depth = 0
        while depth < self.logm_max and self._gal_elts[depth] in gks:
            depth += 1
        if depth < self.logm:
            raise ValueError(
                f"expansion keys cover {depth} levels; even the single-row "
                f"tree needs {self.logm}"
            )
        L, n = len(self.params.qs), self.params.n
        for g in self._gal_elts[:depth]:
            rk = gks[g]
            if rk.digit_bits != DIGIT_BITS:
                raise ValueError(
                    f"galois key {g}: digitBits {rk.digit_bits}; the PIR "
                    f"key switch takes {DIGIT_BITS}"
                )
            if tuple(rk.ext) != self._ext or rk.special_p != self._ext[-1]:
                raise ValueError(
                    f"galois key {g}: basis {tuple(rk.ext)} / special prime "
                    f"{rk.special_p} does not match the service's {self._ext}"
                )
            if rk.b.shape != (L * N_KS_DIGITS, L + 1, n) \
                    or rk.a.shape != rk.b.shape:
                raise ValueError(
                    f"galois key {g}: shape {rk.b.shape} does not match "
                    f"{L * N_KS_DIGITS} components over {L + 1} primes of "
                    f"N={n}"
                )
        fps = tuple(
            hashlib.sha1(json.dumps(wire_by_elt[g], sort_keys=True,
                                    default=str).encode()).hexdigest()
            for g in self._gal_elts[:depth]
        )
        prev = self._key_fps.get(key_id)
        if prev is not None and len(prev) >= depth and prev[:depth] == fps:
            return
        shape = (depth, L * N_KS_DIGITS, L + 1, n)
        kb = np.empty(shape, np.int32)
        ka = np.empty(shape, np.int32)
        for e, q in enumerate(self._ext):
            tb = build_tables(q, n)
            for j, g in enumerate(self._gal_elts[:depth]):
                rk = gks[g]
                kb[j, :, e] = host_ntt(rk.b[:, e] % q, tb)[:, self._fs_perm]
                ka[j, :, e] = host_ntt(rk.a[:, e] % q, tb)[:, self._fs_perm]
        self._keys[key_id] = (torch.from_numpy(kb).to(self.device),
                              torch.from_numpy(ka).to(self.device))
        self._key_fps[key_id] = fps

    # ------------------------------------------------------------------
    def _signed_perm(self, x: torch.Tensor, perm: torch.Tensor,
                     neg: torch.Tensor) -> torch.Tensor:
        """[..., L, N] residues → out[..., i] = ±x[..., perm[i]] mod q."""
        y = x[..., perm]
        return torch.where(neg & (y != 0), self._qs32 - y, y)

    def _mod_down(self, x: torch.Tensor) -> torch.Tensor:
        """[..., L, N] int residues → [..., N] int64 mod q1: the RNS
        modulus switch (q2 residue centred, then exact division by q2)."""
        q1, q2 = self.params.qs
        r2 = x[..., 1, :].to(torch.int64)
        r2c = torch.where(r2 > q2 // 2, r2 - q2, r2)
        return (x[..., 0, :].to(torch.int64) - r2c) % q1 \
            * pow(q2, -1, q1) % q1

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """[..., L, N] → the same shape, int32: one K2 launch a limb over
        every polynomial of that limb."""
        n = self.params.n
        fn = intt4 if inverse else ntt4
        return torch.stack(
            [fn(x[..., i, :].reshape(-1, n), tb).view(x.shape[:-2] + (n,))
             for i, tb in enumerate(self._tabs_q)], dim=-2)

    def _expand(self, c0: torch.Tensor, c1: torch.Tensor, kb, ka,
                logm: int):
        """[B, L, N] query cts → ([B, 2^logm, L, N] int32 c0s, c1s):
        breadth-first, so selector b lands at position b (no bit
        reversal)."""
        B, L, n = c0.shape
        c0s = c0.to(torch.int32)[:, None]
        c1s = c1.to(torch.int32)[:, None]
        for j in range(logm):
            mp, mn = self.mono_perm[j], self.mono_neg[j]
            both0 = torch.cat([c0s, self._signed_perm(c0s, mp, mn)], 1)
            both1 = torch.cat([c1s, self._signed_perm(c1s, mp, mn)], 1)
            del c0s, c1s
            gp, gn = self.gal_perm[j], self.gal_neg[j]
            gb1 = self._signed_perm(both1, gp, gn)
            ks0, ks1 = key_switch(gb1.reshape(-1, L, n), kb[j], ka[j],
                                  self._tabs_ext, DIGIT_BITS)
            del gb1
            shape = both0.shape
            gb0 = self._signed_perm(both0, gp, gn)
            c0s = ((both0.to(torch.int64) + gb0 + ks0.view(shape))
                   % self._qs).to(torch.int32)
            del both0, gb0, ks0
            c1s = ((both1.to(torch.int64) + ks1.view(shape))
                   % self._qs).to(torch.int32)
            del both1, ks1
        return c0s, c1s

    def _fold_dim1(self, s1: torch.Tensor) -> torch.Tensor:
        """s1 [S, g1, 2, L, N] NTT-domain selectors → [S, 2, g2, L, N]
        int64 canonical: C_j = Σ_i s1_i ⊗ db[i, j], one pass over the
        database for all S selector sets."""
        S = s1.shape[0]
        acc = torch.zeros((S, 2, self.g2) + tuple(self.db.shape[2:]),
                          dtype=torch.int64, device=self.db.device)
        for i in range(self.g1):
            acc.addcmul_(s1[:, i, :, None], self.db[i])
            if (i + 1) % _SUMS_PER_REDUCE == 0 or i + 1 == self.g1:
                acc %= self._qs
        return acc

    def _fold_dim2(self, digs: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
        """digs [S, 2·nd, g2, N] base-t digit planes, s2 [S, g2, 2, L, N]
        NTT-domain selectors → [S, 2·nd, 2, L, N] int64 canonical sums."""
        S, nd2, g2, n = digs.shape
        L = len(self.params.qs)
        out = torch.empty((S, nd2, 2, L, n), dtype=torch.int64,
                          device=digs.device)
        flat = digs.reshape(-1, n)
        for i, tb in enumerate(self._tabs_q):
            dn = ntt4(flat, tb).view(S, nd2, g2, n)
            for c in range(2):
                w = s2[:, :, c, i]                          # [S, g2, N]
                r = torch.zeros((S, nd2, n), dtype=torch.int64,
                                device=digs.device)
                for j in range(0, g2, _SUMS_PER_REDUCE):
                    sl = slice(j, j + _SUMS_PER_REDUCE)
                    r += (dn[:, :, sl].to(torch.int64)
                          * w[:, None, sl]).sum(2)
                    r %= tb.q
                out[:, :, c, i] = r
        return out

    def _program(self, c0: torch.Tensor, c1: torch.Tensor, kb, ka,
                 n_rows: int) -> torch.Tensor:
        """The answer program: c0, c1 [B, L, N] coefficient-domain query
        cts → [B, n_rows, 2·nd, 2, N] int32 response residues mod q1."""
        B, L, n = c0.shape
        g1, g2, m = self.g1, self.g2, self.m
        nd = self._n_digits
        t = self.params.t
        logm = self._depth(n_rows)
        with stage("expansion (K2 + elementwise)"):
            c0s, c1s = self._expand(c0, c1, kb, ka, logm)
            take = n_rows * m
            sel = torch.stack([c0s[:, :take], c1s[:, :take]], 2)
            del c0s, c1s
            sel = self._transform(sel, False).view(B * n_rows, m, 2, L, n)
        with stage("dim-1 fold"):
            C = self._fold_dim1(sel[:, :g1])                # [S, 2, g2, L, N]
        with stage("dim-2 fold"):
            cd = self._mod_down(self._transform(C, True))   # [S, 2, g2, N]
            del C
            digs = []
            for _ in range(nd):
                digs.append(cd % t)
                cd = cd // t
            digs = torch.stack(digs, 2).view(B * n_rows, 2 * nd, g2, n)
            R = self._fold_dim2(digs, sel[:, g1:g1 + g2])
            del sel, digs
            out = self._mod_down(self._transform(R, True))  # [S, 2nd, 2, N]
        return out.to(torch.int32).view(B, n_rows, 2 * nd, 2, n)

    # ------------------------------------------------------------------
    def _depth(self, n_rows: int) -> int:
        return max(1, (n_rows * self.m - 1).bit_length())

    def _resp_wire(self, outs: np.ndarray, logf: int) -> dict:
        return {
            "cts": [
                {"c0": pack_i32(outs[i, 0]), "c1": pack_i32(outs[i, 1])}
                for i in range(outs.shape[0])
            ],
            "nDigits": self._n_digits,
            "g1": self.g1,
            "g2": self.g2,
            "logF": logf,
        }

    def _query_c01(self, query_wire: dict) -> Tuple[np.ndarray, np.ndarray]:
        ct = Ciphertext.from_wire(query_wire)
        if ct.is_ntt:
            ct = self.ctx.from_ntt(ct)
        shape = (len(self.params.qs), self.params.n)
        if ct.c0.shape != shape:
            raise ValueError(f"PIR query ct shape {ct.c0.shape}, "
                             f"expected {shape}")
        return ct.c0, ct.c1

    def _answer(self, query_wires: list, key_id: str,
                n_rows: int) -> List[dict]:
        """Every ct's n_rows responses, in order, the cts in chunks of at
        most MAX_EXPANDED // 2^logm a program, one program of the service
        on the device at a time."""
        kb, ka = self._keys[key_id]
        logm = self._depth(n_rows)
        if kb.shape[0] < logm:
            raise ValueError(
                f"expansion keys cover {kb.shape[0]} levels; "
                f"{n_rows} packed rows need {logm}"
            )
        with stage("wire decode"):
            pairs = [self._query_c01(w) for w in query_wires]
        cap = max(1, MAX_EXPANDED >> logm)
        out: List[dict] = []
        for i in range(0, len(pairs), cap):
            chunk = pairs[i:i + cap]
            with self._lock:
                with stage("upload"):
                    c0 = torch.from_numpy(np.stack([c[0] for c in chunk])).to(
                        self.device)
                    c1 = torch.from_numpy(np.stack([c[1] for c in chunk])).to(
                        self.device)
                res = self._program(c0, c1, kb, ka, n_rows)
                with stage("download"):
                    res = res.cpu().numpy()
            with stage("pack_i32"):
                out.extend(self._resp_wire(res[b, r], logm)
                           for b in range(len(chunk)) for r in range(n_rows))
        return out

    def answer_2d(self, query_wire: dict, key_id: str) -> dict:
        """ONE query ct → the 2·n_digits single-limb response cts."""
        return self._answer([query_wire], key_id, 1)[0]

    def answer_2d_batch(self, query_wires: list, key_id: str) -> list:
        """B single-row fetches, every chunk's selector sets folded against
        one pass over the database; responses in order."""
        return self._answer(list(query_wires), key_id, 1)

    def answer_2d_multi(self, query_wire: dict, key_id: str,
                        n_rows: int) -> list:
        """ONE packed ct (build_query_2d_multi) → n_rows response dicts.
        Needs expansion keys to depth ⌈log2(n_rows·m)⌉
        (galois_keys_wire_2d_multi)."""
        return self.answer_2d_multi_batch([query_wire], key_id, n_rows)

    def answer_2d_multi_batch(self, query_wires: list, key_id: str,
                              n_rows: int) -> list:
        """Several packed cts, each carrying n_rows row-fetches →
        len(query_wires)·n_rows responses in order."""
        if not 1 <= n_rows <= self.rows_per_ct():
            raise ValueError(
                f"n_rows={n_rows} outside [1, {self.rows_per_ct()}]"
            )
        return self._answer(list(query_wires), key_id, n_rows)

    def answer_2d_sharded(self, query_wire: dict, key_id: str, mesh) -> dict:
        raise NotImplementedError(
            "answer_2d_sharded is not ported yet (it comes with sharding "
            "over torch.distributed, ROADMAP queue 1 item 5)"
        )
