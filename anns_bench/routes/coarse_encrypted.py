"""``"coarse+encrypted"``: PreFHEtch's two rounds a batch, a binary top-k
``/coarsesearch`` for the candidates, then a JSON ``/encryptedsearch`` for
their encrypted distances, on the wire the configuration's ``he`` block
states (``scheme``, ``resp_mod``), whose client is
``client/<scheme>_<resp_mod>.py``.

Each client is a user with keys of its own, cycling through
``batches_per_client`` encrypted batches made before the window; its
first warm-up request registers its Galois keys where the wire has any.
A window's coarse answer is held to the candidates baked into the
prepared body, and the body is made again where they differ. An answer is
the coarse candidates and their decrypted distances.
"""

from __future__ import annotations

import json

import numpy as np

from anns_bench.cell import load
from anns_bench.client import wire
from anns_bench.judge import judge_rerank as judge  # noqa: F401
from anns_bench.reference import bf16_distances, bf16_topk
from anns_bench.traffic import BIN, JSON, Traffic


class Route(Traffic):
    def _prepare(self) -> None:
        he = self.config["he"]
        d = int(self.config["dataset"]["d"])
        nb = int(self.mix["batches_per_client"])
        n = len(self.queries)
        client = load("client", f"{he['scheme']}_{he['resp_mod']}").Client
        self.users, self.batch_rows, self.coarse_bodies = [], [], []
        self.enc_parts, self.enc_bodies, self.baked = [], [], []
        for c in range(self.n_clients):
            with self.host.part("keys"):
                user = client(int(he["n"]), int(he["t_bits"]),
                              int(he["n_limbs"]), seed=self.seed * 64 + c,
                              key_id=f"anns-bench-user-{c}")
                user.keys_wire = user.galois_keys_wire(d)
            self.users.append(user)
            rows_c, coarse_c, parts_c, bodies_c, baked_c = [], [], [], [], []
            for i in range(nb):
                rows = ((c * nb + i) * self.rows + np.arange(self.rows)) % n
                coarse = wire.encode(wire.KIND_COARSE_TOPK_REQ, [
                    self.queries[rows], self.probes[rows],
                    np.asarray([self.coarse_probe], np.uint32)])
                # the candidates of this batch, as the program answers them
                # now; a window answer is held to them before the baked
                # body is sent
                with self.host.part("coarse answers"):
                    st, _, resp = self.handle("POST", "/coarsesearch", BIN,
                                              coarse)
                if st != 200:
                    raise RuntimeError(f"/coarsesearch answered {st}")
                ids = wire.decode(resp)[1][0].copy()
                with self.host.part("encrypt"):
                    enc = user.encrypt_batch(self.queries[rows])
                parts = {"encryptedPreciseQuery": enc,
                         "scheme": he["scheme"], "respMod": he["resp_mod"],
                         "keyId": user.key_id}
                rows_c.append(rows)
                coarse_c.append(coarse)
                parts_c.append(parts)
                bodies_c.append(self._enc_body(parts, ids))
                baked_c.append(ids)
            self.batch_rows.append(rows_c)
            self.coarse_bodies.append(coarse_c)
            self.enc_parts.append(parts_c)
            self.enc_bodies.append(bodies_c)
            self.baked.append(baked_c)

    @staticmethod
    def _enc_body(parts: dict, ids: np.ndarray, extra: dict = None) -> bytes:
        body = dict(parts, nearestCoarseVectorIndexes=ids.tolist())
        if extra:
            body.update(extra)
        return json.dumps(body).encode()

    def _send_two_round(self, c: int, i: int, keys: bool = False):
        st, _, resp = self.tracer.timed(
            "handle:/coarsesearch", self.handle, "POST",
            "/coarsesearch", BIN, self.coarse_bodies[c][i])
        if st != 200:
            return False, None
        try:
            ids = wire.decode(resp)[1][0]
        except (ValueError, IndexError):
            return False, None
        if keys and self.users[c].keys_wire:
            body = self._enc_body(self.enc_parts[c][i], ids,
                                  {"galoisKeys": self.users[c].keys_wire})
        elif ids.shape == self.baked[c][i].shape and np.array_equal(
                ids, self.baked[c][i]):
            body = self.enc_bodies[c][i]
        else:
            self.rebuilt += 1
            body = self._enc_body(self.enc_parts[c][i], ids)
        st, _, enc = self.tracer.timed(
            "handle:/encryptedsearch", self.handle, "POST",
            "/encryptedsearch", JSON, body)
        return st == 200, (ids, enc)

    def _items(self, c: int):
        return list(range(len(self.coarse_bodies[c])))

    def _send(self, c: int, item: int, first: bool = False):
        return self._send_two_round(c, item, keys=first)

    @property
    def width(self) -> int:
        return self.coarse_probe

    def _decode(self, r):
        cand, enc = r.answer
        rows = self.batch_rows[r.client][r.item]
        resp = json.loads(enc)
        d = self.users[r.client].decrypt(resp, self.queries[rows])
        ids = cand.astype(np.int64)
        if d.shape != ids.shape:
            raise ValueError("decrypted distances of the wrong shape")
        return rows, ids, d


def answered(mix: dict, n_pool: int) -> np.ndarray:
    """The pool rows of every client's batches."""
    rows, clients = int(mix["rows_per_request"]), int(mix["clients"])
    nb = int(mix["batches_per_client"])
    return np.unique(np.arange(clients * nb * rows) % n_pool)


def control(ref, queries: np.ndarray, config: dict):
    """The bfloat16 top-COARSE_PROBE as the candidates, and their bfloat16
    distances as the decrypted ones."""
    cand, _ = bf16_topk(ref, queries, int(config["protocol"]["coarse_probe"]))
    return cand, bf16_distances(ref, queries, cand)
