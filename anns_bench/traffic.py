"""The one traffic generator: every traffic mix is a file of parameters in
workloads/ that this module reads.

Parameters of a mix:

- ``route``: ``"search"`` (the fused triage round, binary ``/search``) or
  ``"coarse+encrypted"`` (binary top-k ``/coarsesearch`` for the
  candidates, then JSON ``/encryptedsearch`` on the packed BFV wire);
- ``entry``: ``"dispatcher"``, the program's ``Dispatcher.handle`` in
  process (the only entry so far);
- ``rows_per_request``: queries a request carries;
- ``clients``: closed-loop client threads (each sends its next request
  when the last one is answered);
- ``batches_per_client``: for the encrypted route, the encrypted batches
  each client cycles through (every body is made before the window);
- ``warm_requests``: synchronous requests before the window (for the
  search route, as many as it has batches sends each once).

Every request body is made before the window. Requests cycle through the
configuration's query pool; the search route cuts it into the same batches
for every seed and sends them in an order drawn from the seed. A request's
latency runs from its send to its full answer, and a request is sent only
while the window is open.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from anns_bench.client import wire
from anns_bench.client.bfv import PackedClient
from anns_bench.client.ranking import nearest_centroids

BIN = {"content-type": wire.CONTENT_TYPE, "accept": wire.CONTENT_TYPE}
JSON = {"content-type": "application/json"}


@dataclasses.dataclass
class Req:
    client: int
    item: int                 # the batch sent
    t_send: float             # time.monotonic()
    t_done: float
    ok: bool
    answer: object = None     # route-specific, decoded after the window
    spans: Optional[dict] = None


class Traffic:
    """A mix bound to a configuration, a system and the run's queries."""

    def __init__(self, mix: dict, config: dict, system, queries: np.ndarray,
                 seed: int, tracer):
        self.mix, self.config, self.system = mix, config, system
        self.queries = queries
        self.seed = seed
        self.tracer = tracer
        self.rows = int(mix["rows_per_request"])
        self.n_clients = int(mix["clients"])
        pr = config["protocol"]
        self.k, self.nprobe = int(pr["k"]), int(pr["nprobe"])
        self.coarse_probe = int(pr["coarse_probe"])
        self.rebuilt = 0
        self.warm_failed = 0
        if mix["entry"] != "dispatcher":
            raise ValueError(f"unknown entry {mix['entry']!r}")

    # -- set-up ----------------------------------------------------------------
    def prepare(self) -> None:
        """The client side's work before the window: the centroids (GET
        /query), each query's probes, and every request body."""
        st, _, body = self.system.handle("GET", "/query", BIN, b"")
        if st != 200:
            raise RuntimeError(f"GET /query answered {st}")
        _, (centroids,) = wire.decode(body)
        self.probes = nearest_centroids(self.queries, centroids, self.nprobe)
        route = self.mix["route"]
        if route == "search":
            n = len(self.queries)
            nb = -(-n // self.rows)
            self.batch_rows = [(b * self.rows + np.arange(self.rows)) % n
                               for b in range(nb)]
            self.bodies = [self._search_body(r) for r in self.batch_rows]
            # the same batches for every seed; the seed orders them
            self.order = np.random.default_rng(
                self.seed % (1 << 63)).permutation(nb)
        elif route == "coarse+encrypted":
            self._prepare_encrypted()
        else:
            raise ValueError(f"unknown route {route!r}")

    def _search_body(self, rows: np.ndarray) -> bytes:
        return wire.encode(wire.KIND_SEARCH_REQ, [
            self.queries[rows], self.probes[rows],
            np.asarray([self.k], np.uint32)])

    def _prepare_encrypted(self) -> None:
        he = self.config["he"]
        d = int(self.config["dataset"]["d"])
        nb = int(self.mix["batches_per_client"])
        n = len(self.queries)
        self.users, self.batch_rows, self.coarse_bodies = [], [], []
        self.enc_parts, self.enc_bodies, self.baked = [], [], []
        for c in range(self.n_clients):
            user = PackedClient(int(he["n"]), int(he["t_bits"]),
                                int(he["n_limbs"]), seed=self.seed * 64 + c,
                                key_id=f"anns-bench-user-{c}")
            user.keys_wire = user.extraction_keys_wire(d)
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
                st, _, resp = self.system.handle("POST", "/coarsesearch",
                                                 BIN, coarse)
                if st != 200:
                    raise RuntimeError(f"/coarsesearch answered {st}")
                ids = wire.decode(resp)[1][0].copy()
                parts = {"encryptedPreciseQuery":
                         user.encrypt_batch(self.queries[rows]),
                         "scheme": "bfv", "respMod": he["resp_mod"],
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

    # -- one request -------------------------------------------------------------
    def _send_search(self, c: int, b: int):
        st, _, resp = self.tracer.timed("handle:/search", self.system.handle,
                                        "POST", "/search", BIN, self.bodies[b])
        return st == 200, resp

    def _send_two_round(self, c: int, i: int, keys: bool = False):
        st, _, resp = self.tracer.timed(
            "handle:/coarsesearch", self.system.handle, "POST",
            "/coarsesearch", BIN, self.coarse_bodies[c][i])
        if st != 200:
            return False, None
        try:
            ids = wire.decode(resp)[1][0]
        except (ValueError, IndexError):
            return False, None
        if keys:
            body = self._enc_body(self.enc_parts[c][i], ids,
                                  {"galoisKeys": self.users[c].keys_wire})
        elif ids.shape == self.baked[c][i].shape and np.array_equal(
                ids, self.baked[c][i]):
            body = self.enc_bodies[c][i]
        else:
            self.rebuilt += 1
            body = self._enc_body(self.enc_parts[c][i], ids)
        st, _, enc = self.tracer.timed(
            "handle:/encryptedsearch", self.system.handle, "POST",
            "/encryptedsearch", JSON, body)
        return st == 200, (ids, enc)

    def _items(self, c: int) -> List[int]:
        if self.mix["route"] == "search":
            return [int(b) for b in self.order[c::self.n_clients]]
        return list(range(len(self.coarse_bodies[c])))

    def _send(self, c: int, item: int):
        if self.mix["route"] == "search":
            return self._send_search(c, item)
        return self._send_two_round(c, item)

    # -- warm-up -----------------------------------------------------------------
    def warm(self) -> None:
        """Synchronous requests of the cell's own kind before the window
        (the encrypted route registers each user's Galois keys with its
        first one). A failed one is counted, not raised: the window's
        requests show what is wrong."""
        n = int(self.mix["warm_requests"])
        for c in range(self.n_clients):
            items = self._items(c)
            for w in range(n):
                if self.mix["route"] == "search":
                    ok, _ = self._send_search(c, items[w % len(items)])
                else:
                    ok, _ = self._send_two_round(c, items[w % len(items)],
                                                 keys=(w == 0))
                self.warm_failed += not ok

    # -- the window ----------------------------------------------------------------
    def run_window(self, t0: float, seconds: float, during=None) -> List[Req]:
        """Closed-loop clients from ``t0`` (time.monotonic) for ``seconds``;
        ``during`` runs on the calling thread meanwhile."""
        deadline = t0 + seconds
        out: List[List[Req]] = [[] for _ in range(self.n_clients)]
        errors: List[str] = []

        def client(c: int) -> None:
            items = self._items(c)
            i = 0
            while time.monotonic() < t0:
                time.sleep(0.0005)
            try:
                while True:
                    t_send = time.monotonic()
                    if t_send >= deadline:
                        break
                    item = items[i % len(items)]
                    i += 1
                    with self.tracer.request() as spans:
                        ok, answer = self._send(c, item)
                    out[c].append(Req(c, item, t_send, time.monotonic(), ok,
                                      answer, spans))
            except Exception as e:          # reported after the join
                errors.append(f"client {c}: {e!r}")

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(self.n_clients)]
        for t in threads:
            t.start()
        if during is not None:
            during()
        for t in threads:
            t.join(timeout=seconds + 120)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError("client failure: " + "; ".join(errors))
        return [r for rs in out for r in rs]

    # -- answers -----------------------------------------------------------------------
    def answers(self, reqs: List[Req]) -> Dict[str, np.ndarray]:
        """Decode the window's answers for the judge (client-side work,
        after the window): rows, ids and distances, or the coarse
        candidates and their decrypted distances; ``failed`` counts the
        requests whose answer was an error, malformed or misshapen."""
        route = self.mix["route"]
        qidx, a_ids, a_d = [], [], []
        failed = 0
        for r in reqs:
            try:
                if not r.ok:
                    raise ValueError("error status")
                rows, ids, d = self._decode(route, r)
            except (ValueError, KeyError, IndexError, TypeError):
                failed += 1
                continue
            qidx.append(rows)
            a_ids.append(ids)
            a_d.append(d)
        if not qidx:
            width = self.coarse_probe if route != "search" else self.k
            return {"qidx": np.empty(0, np.int64), "failed": failed,
                    "ids": np.empty((0, width), np.int64),
                    "dist": np.empty((0, width))}
        return {"qidx": np.concatenate(qidx), "failed": failed,
                "ids": np.concatenate(a_ids), "dist": np.concatenate(a_d)}

    def _decode(self, route: str, r: Req):
        if route == "search":
            kind, secs = wire.decode(r.answer)
            if kind != wire.KIND_SEARCH or len(secs) != 2:
                raise ValueError("not a /search answer")
            rows = self.batch_rows[r.item]
            ids, d = secs[0].astype(np.int64), secs[1].astype(np.float64)
        else:
            cand, enc = r.answer
            rows = self.batch_rows[r.client][r.item]
            resp = json.loads(enc)
            d = self.users[r.client].decrypt_packed(resp, self.queries[rows])
            ids = cand.astype(np.int64)
            if d.shape != ids.shape:
                raise ValueError("decrypted distances of the wrong shape")
        width = self.k if route == "search" else self.coarse_probe
        if ids.shape != (len(rows), width) or d.shape != ids.shape:
            raise ValueError("answer of the wrong shape")
        return rows, ids, d
