"""``"pir-fetch"``: PreFHEtch's last round, the private fetch of the rows a
client has ranked, one JSON ``/pir-fetch`` ``pirHypercubeMulti`` a request
(SealPIR-style 2-D PIR on the wire the configuration's ``he`` block states;
its client is ``client/pir_hypercube.py``).

Each client is a user with keys of its own, cycling through the fetches of
``queries_per_client`` pool rows (the first ones, as the two-round route
takes its batches), ``rows_per_request`` queries a fetch. Before the window
one binary ``/search`` of those queries names the k ids of each (the
triage's answer, nearest first), and every body is made: the ids in
ciphertexts of min(⌊N/m⌋, k) rows (m = G1 + G2 selectors a row), the last
padded by repeating its final row, its true count kept on the client. The
first warm-up request registers the user's Galois keys. The server sees
one ciphertext per ⌊N/m⌋ rows and no row index.

After the window each answer is decrypted; an answer is the requested ids
and the exact squared L2 distance of each decrypted row to its query, what
the user computes with the vectors it fetched. A value outside 0..255, or
a row or ciphertext missing, makes the answer malformed (``failed``).
``judge.judge_search`` holds it: with float64 distances of integer rows,
``dist_gap`` 0 holds every row exactly, and the order is the triage's.
"""

from __future__ import annotations

import json

import numpy as np

from anns_bench.client import wire
from anns_bench.client.pir_hypercube import Client, grid_dims
from anns_bench.judge import judge_search as judge  # noqa: F401
from anns_bench.traffic import BIN, JSON, Traffic

VALUE_MAX = 255


def rows_per_ct(config: dict) -> int:
    """Rows a query ciphertext carries: ⌊N/m⌋ (the program's
    ``rows_per_ct``), at most k."""
    ds, he = config["dataset"], config["he"]
    n = int(he["n"])
    _, g1, g2 = grid_dims(n, int(ds["nbase"]), int(ds["d"]))
    return max(1, min(n // (g1 + g2), int(config["protocol"]["k"])))


def chunks(ids: np.ndarray, n_rows: int):
    """[(rows of one ciphertext, padded to n_rows; its true count)]."""
    flat = [int(i) for i in np.asarray(ids).reshape(-1)]
    out = []
    for s in range(0, len(flat), n_rows):
        c = flat[s:s + n_rows]
        out.append((c + [c[-1]] * (n_rows - len(c)), len(c)))
    return out


class Route(Traffic):
    def _prepare(self) -> None:
        he, ds = self.config["he"], self.config["dataset"]
        if he.get("pir_wire") != "hypercube_multi":
            raise ValueError(f"the pir-fetch route speaks hypercube_multi, "
                             f"not {he.get('pir_wire')!r}")
        self.d, self.nbase = int(ds["d"]), int(ds["nbase"])
        self.n_rows = rows_per_ct(self.config)
        per = int(self.mix["queries_per_client"])
        if per % self.rows:
            raise ValueError("queries_per_client is not a multiple of "
                             "rows_per_request")
        n = len(self.queries)
        self.users, self.batch_rows, self.ids = [], [], []
        self.offsets, self.bodies, self.key_bodies = [], [], []
        for c in range(self.n_clients):
            rows = (c * per + np.arange(per)) % n
            body = wire.encode(wire.KIND_SEARCH_REQ, [
                self.queries[rows], self.probes[rows],
                np.asarray([self.k], np.uint32)])
            with self.host.part("search answers"):
                st, _, resp = self.handle("POST", "/search", BIN, body)
            if st != 200:
                raise RuntimeError(f"/search answered {st}")
            ids = wire.decode(resp)[1][0].astype(np.int64)
            with self.host.part("keys"):
                user = Client(int(he["n"]), int(he["pir_plain_modulus"]),
                              int(he["n_limbs"]), seed=self.seed * 64 + c,
                              key_id=f"anns-bench-pir-user-{c}")
                keys = user.galois_keys_wire(self.nbase, self.d, self.n_rows)
            fetches = [np.arange(b * self.rows, (b + 1) * self.rows)
                       for b in range(per // self.rows)]
            parts = [chunks(ids[sel], self.n_rows) for sel in fetches]
            with self.host.part("encrypt"):
                wires = iter(user.query_wires(
                    [c for part in parts for c, _ in part], self.nbase,
                    self.d))
            rows_c, ids_c, offs_c, bodies_c = [], [], [], []
            for sel, part in zip(fetches, parts):
                entries, offs = [], []
                for _, valid in part:
                    w, rs = next(wires)
                    entries.append({"ct": w, "nRows": self.n_rows})
                    offs.append((valid, rs[:valid]))
                rows_c.append(rows[sel])
                ids_c.append(ids[sel])
                offs_c.append(offs)
                bodies_c.append({"pirHypercubeMulti": entries,
                                 "keyId": user.key_id})
            self.users.append(user)
            self.batch_rows.append(rows_c)
            self.ids.append(ids_c)
            self.offsets.append(offs_c)
            self.key_bodies.append(json.dumps(
                dict(bodies_c[0], galoisKeys=keys)).encode())
            self.bodies.append([json.dumps(b).encode() for b in bodies_c])

    def _items(self, c: int):
        return list(range(len(self.bodies[c])))

    def _send(self, c: int, item: int, first: bool = False):
        # a client's first warm-up request is its first fetch with its keys
        body = self.key_bodies[c] if first else self.bodies[c][item]
        st, _, resp = self.tracer.timed("handle:/pir-fetch", self.handle,
                                        "POST", "/pir-fetch", JSON, body)
        return st == 200, resp

    @property
    def width(self) -> int:
        return self.k

    def _decode(self, r):
        results = json.loads(r.answer)["pirResults"]
        offs = self.offsets[r.client][r.item]
        if len(results) != len(offs) * self.n_rows:
            raise ValueError(f"{len(results)} responses for "
                             f"{len(offs) * self.n_rows} fetched rows")
        keep, rs = [], []
        for i, (valid, r_offs) in enumerate(offs):
            keep.extend(results[i * self.n_rows: i * self.n_rows + valid])
            rs.extend(r_offs)
        got = self.users[r.client].decode(keep, self.d, rs)
        if got.min(initial=0) < 0 or got.max(initial=0) > VALUE_MAX:
            raise ValueError("a decrypted value outside 0..255")
        rows = self.batch_rows[r.client][r.item]
        ids = self.ids[r.client][r.item]
        vec = got.reshape(len(rows), self.k, self.d).astype(np.float64)
        q = self.queries[rows].astype(np.float64)
        dist = ((vec - q[:, None, :]) ** 2).sum(-1)
        return rows, ids, dist


def answered(mix: dict, n_pool: int) -> np.ndarray:
    """The pool rows of every client's fetches."""
    n = int(mix["clients"]) * int(mix["queries_per_client"])
    return np.unique(np.arange(n) % n_pool)


def control(ref, queries: np.ndarray, config: dict):
    """The reference's exact top k as the fetched ids, each row answered by
    its block neighbour (id xor 1), what a selector one slot off returns:
    the ids and the exact distances of the neighbours' rows."""
    ids = ref.exact_topk(queries, int(config["protocol"]["k"]))
    return ids, ref.distances(queries, ids ^ 1)
