"""Device-resident 2-D PIR answering — the port of
prefhetch_tpu/engine/pir_device.py ``DevicePIR2``, the device twin of
crypto/pir.py ``PIR2Server`` with the same wire contract.

Per request the host uploads the query ciphertexts (coefficient domain,
one [L, N] pair each) and downloads 2·n_digits single-limb response
ciphertexts a fetched row; the packed database and the client's expansion
keys stay on the device. The answer program, eager PyTorch on int32/int64
tensors, for a chunk of B query ciphertexts at once:

1. breadth-first oblivious expansion to 2^logm selectors a ciphertext:
   logm rounds, each a signed monomial permutation and one rotation step
   (engine/hecompute.py ``rotate_add``, shared with the packed BFV and
   CKKS programs: a signed Galois permutation and a key switch, 15-bit
   digits; on the card five launches of ops/key_switch.py's kernels
   around K2's six, int32 throughout) over every ciphertext of the round;
2. one forward transform a limb of every selector that is used;
3. the dim-1 fold C_j = Σ_i sel_i ⊗ db[i, j] over the g1 rows of the
   [g1, g2] hypercube (ops/pir_fold.py ``fold_dim1``: one launch of the
   kernel ``csrc/pir_fold1.cu`` on the card, its sums in registers; its
   plain version on CPU tensors): one pass over the database serves every
   selector set of the chunk (every row of a multi-row ciphertext and every
   ciphertext); one inverse transform a limb;
4. the RNS modulus switch to q1 (the q2 residue centred first) and the
   base-t digits of the g2 column ciphertexts, one forward transform a limb
   of all 2·n_digits digit planes;
5. the dim-2 fold with the selectors g1..g1+g2, one inverse transform a
   limb of the 2·n_digits sums, and the switch to q1.

Every transform is one call of ``ops/ntt4.ntt4``/``intt4``: one launch of
kernel K2 on the card, its plain version on CPU tensors. A chunk takes
6·logm + 4·L K2 launches (62 for single-row ciphertexts and 80 for fully
packed multi-row ones at the SIFT1M preset: N=4096, L=2, g1 = g2 = 177) and
one launch of the fold's kernel. Modular products are ``%`` on int64, the
fold's and the key switch's sums exact u64, so the responses are
bit-equal to the JAX program's and to ``PIR2Server``'s. The NTT domain of
this module is in four-step order: the database (transformed on the device
by K2, which emits that order) and the key stacks (host NTT, then
``fourstep_perm``); the wire stays in the natural coefficient domain.

``answer_2d_sharded`` runs the dim-1 fold over the database sharded on a
mesh (parallel/mesh.py), each shard folding its g1/ndev rows; the int64 sum
of the shards' canonical int32 partials, reduced once mod q, is the
single-device fold, so the response is bit-equal to ``answer_2d``.

Inside ``record_stages()`` a request counts (utils/stages.py ``count``)
``pir.cts`` query ciphertexts, ``pir.rows`` row fetches (padding
included), and per program ``pir.programs``, ``pir.expanded`` (B·2^logm
ciphertexts after expansion) and ``pir.selector_sets`` (B·n_rows); K2's
wrappers count the rows each launch transforms (``k2.rows.i32``,
``k2.rows.i64``), the fold's wrapper its launches
(``pir.fold1.launches``) and the key switch's its kernels' launches
(``he.ks.launches``, five a round).

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
from prefhetch_tpu_torch.crypto.params import BFVParams
from prefhetch_tpu_torch.crypto.pir import grid_dims, pack_database
from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.engine.hecompute import (
    Rotations, automorphism_tables, galois_key_tables, rotate_add,
)
from prefhetch_tpu_torch.ops.key_switch import signed_perm
from prefhetch_tpu_torch.ops.ntt4 import build_ntt4_tables, intt4, ntt4
from prefhetch_tpu_torch.ops.pir_fold import fold_dim1
from prefhetch_tpu_torch.utils.stages import count, stage
from prefhetch_tpu_torch.utils.wire import pack_i32

DIGIT_BITS = 15

# Expanded selector ciphertexts one program holds at its widest round
# (B query ciphertexts × 2^logm). At N=4096 and L=2 a program peaks at
# ~0.35 MB an expanded ciphertext: 40,960 = ten fully packed multi-row
# ciphertexts (10 × 4,096, the 100-row fetch of one query at SIFT1M) peaked
# at 14,181,859,328 B above what the card already held, the 1,026.6 MB
# database among it, on an H100 80GB (chip_smoke.py [pir]); the widest
# round of the expansion holds ~0.26 MB of it a ciphertext (its two int32
# halves, their int32 key-switch digits, one prime's transformed digits and
# the int32 inverses of three primes, ops/key_switch.py). 80 single-row
# ciphertexts (m_pad = 512) take the same cap. The frontends answer
# requests on several threads, and a service runs its programs one at a
# time (``DevicePIR2._lock``), so the cap bounds the card's share whatever
# the concurrency.
MAX_EXPANDED = 40_960

# the dim-2 fold: products < q² < 2^60, seven of them and a residue < q
# stay below 2^63
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
        self._ext = tuple(params.qs) + (self.ctx._special_p,)
        self._tabs_ext = [build_ntt4_tables(q, n) for q in self._ext]
        self._tabs_q = self._tabs_ext[:L]
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
        for j in range(self.logm_max):
            # out[pos[k]] = sign[k]·in[k]  →  out[i] = sg[i]·in[pm[i]]
            dest = (k + (-(1 << j)) % (2 * n)) % (2 * n)
            mono_perm[j, dest % n] = k
            mono_neg[j, dest % n] = dest >= n
        self.mono_perm = torch.from_numpy(mono_perm).to(self.device)
        self.mono_neg = torch.from_numpy(mono_neg).to(self.device)
        self._gal_elts = [(n >> j) + 1 for j in range(self.logm_max)]
        self.gal_perm, self.gal_neg = automorphism_tables(
            self.ctx, self._gal_elts, self.device)
        # key_id -> the expansion's Rotations, kb, ka [depth, n_comp, L+1,
        # N] int32 in four-step order
        self._keys: Dict[str, Rotations] = {}
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
        """Park the key components on the device, stacked per level
        (engine/hecompute.py ``galois_key_tables``).

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
        keys = {g: gks[g] for g in self._gal_elts[:depth]}
        for g, rk in keys.items():
            if rk.digit_bits != DIGIT_BITS:
                raise ValueError(
                    f"galois key {g}: digitBits {rk.digit_bits}; the PIR "
                    f"key switch takes {DIGIT_BITS}"
                )
        fps = tuple(
            hashlib.sha1(json.dumps(wire_by_elt[g], sort_keys=True,
                                    default=str).encode()).hexdigest()
            for g in self._gal_elts[:depth]
        )
        prev = self._key_fps.get(key_id)
        if prev is not None and len(prev) >= depth and prev[:depth] == fps:
            return
        kb, ka, _ = galois_key_tables(keys, self._tabs_ext, self.device)
        self._keys[key_id] = Rotations(kb, ka, self.gal_perm, self.gal_neg,
                                       self._tabs_ext, DIGIT_BITS)
        self._key_fps[key_id] = fps

    # ------------------------------------------------------------------
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

    def _expand(self, c0: torch.Tensor, c1: torch.Tensor, rot: Rotations,
                logm: int):
        """[B, L, N] query cts → ([B, 2^logm, L, N] int32 c0s, c1s):
        breadth-first, so selector b lands at position b (no bit
        reversal)."""
        c0s = c0.to(torch.int32)[:, None]
        c1s = c1.to(torch.int32)[:, None]
        for j in range(logm):
            mp, mn = self.mono_perm[j], self.mono_neg[j]
            both0 = torch.cat([c0s, signed_perm(c0s, mp, mn, self._qs32)], 1)
            both1 = torch.cat([c1s, signed_perm(c1s, mp, mn, self._qs32)], 1)
            del c0s, c1s
            c0s, c1s = rotate_add(both0, both1, both0, both1, rot, j)
            del both0, both1
        return c0s, c1s

    def _fold_dim1(self, s1: torch.Tensor, db: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """s1 [S, rows, 2, L, N] NTT-domain selectors → [S, 2, g2, L, N]
        int32 canonical: C_j = Σ_i s1_i ⊗ db[i, j], one pass over the
        database rows (default all g1, else a shard's) for all S selector
        sets."""
        return fold_dim1(s1, self.db if db is None else db, self.params.qs)

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

    def _program(self, c0: torch.Tensor, c1: torch.Tensor, rot: Rotations,
                 n_rows: int, fold1=None) -> torch.Tensor:
        """The answer program: c0, c1 [B, L, N] coefficient-domain query
        cts → [B, n_rows, 2·nd, 2, N] int32 response residues mod q1.
        ``fold1`` replaces the dim-1 fold (the sharded answer's)."""
        B, L, n = c0.shape
        g1, g2, m = self.g1, self.g2, self.m
        nd = self._n_digits
        t = self.params.t
        logm = self._depth(n_rows)
        count("pir.programs", 1)
        count("pir.expanded", B << logm)
        count("pir.selector_sets", B * n_rows)
        with stage("expansion (K2 + elementwise)"):
            c0s, c1s = self._expand(c0, c1, rot, logm)
            take = n_rows * m
            sel = torch.stack([c0s[:, :take], c1s[:, :take]], 2)
            del c0s, c1s
            sel = self._transform(sel, False).view(B * n_rows, m, 2, L, n)
        with stage("dim-1 fold"):
            C = (fold1 or self._fold_dim1)(sel[:, :g1])     # [S, 2, g2, L, N]
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
        rot = self._keys[key_id]
        logm = self._depth(n_rows)
        if rot.kb.shape[0] < logm:
            raise ValueError(
                f"expansion keys cover {rot.kb.shape[0]} levels; "
                f"{n_rows} packed rows need {logm}"
            )
        with stage("wire decode"):
            pairs = [self._query_c01(w) for w in query_wires]
        count("pir.cts", len(pairs))
        count("pir.rows", len(pairs) * n_rows)
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
                res = self._program(c0, c1, rot, n_rows)
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
        """Single-row answer with the packed database sharded over the mesh
        (parallel/mesh.py): each shard folds its g1/ndev rows of the
        hypercube in the dim-1 fold (the stage that reads the database),
        and an int64 sum of the shards' canonical int32 partials (< ndev·q)
        with one reduction mod q reassembles the fold bit-equal to
        answer_2d. Expansion and the dim-2 fold run once, on the service's
        device. A shard on that device is a view of the database. Requires
        g1 % ndev == 0."""
        ndev = mesh.ndev
        if self.g1 % ndev:
            raise ValueError(
                f"g1={self.g1} not divisible by {ndev} devices"
            )
        chunk = self.g1 // ndev
        dbs = [(gid, self.db[gid * chunk:(gid + 1) * chunk].to(dev))
               for gid, dev in mesh.local_shards()]

        def fold1(s1):
            parts = [self._fold_dim1(s1[:, gid * chunk:(gid + 1) * chunk]
                                     .to(db.device), db)
                     for gid, db in dbs]
            return (mesh.psum([p.to(torch.int64) for p in parts])
                    .to(self.device)) % self._qs

        rot = self._keys[key_id]
        with stage("wire decode"):
            c0, c1 = self._query_c01(query_wire)
        count("pir.cts", 1)
        count("pir.rows", 1)
        with self._lock:
            with stage("upload"):
                c0 = torch.from_numpy(c0[None]).to(self.device)
                c1 = torch.from_numpy(c1[None]).to(self.device)
            res = self._program(c0, c1, rot, 1, fold1=fold1)
            with stage("download"):
                res = res.cpu().numpy()
        with stage("pack_i32"):
            return self._resp_wire(res[0, 0], self._depth(1))
