"""The one traffic generator: every traffic mix is a file of parameters in
workloads/ that this module reads.

Parameters of a mix:

- ``route``: the request kind, ``routes/<route>.py`` (a character outside
  letters, digits and ``_`` is spelt ``_`` in the file's name): how the
  bodies are made before the window, what one request sends, how an answer
  decodes and which judge holds it. ``"search"``: the fused triage round,
  binary ``/search``; ``"coarse+encrypted"``: binary top-k
  ``/coarsesearch`` for the candidates, then JSON ``/encryptedsearch`` on
  the HE wire the configuration states;
- ``entry``: where a request enters the program, ``entries/<entry>.py``;
  ``"dispatcher"`` is the program's ``Dispatcher.handle`` in process;
- ``rows_per_request``: queries a request carries;
- ``clients``: closed-loop client threads (each sends its next request
  when the last one is answered);
- ``warm_requests``: synchronous requests before the window;
- and what its route reads besides (``batches_per_client``).

Every request body is made before the window. A request's latency runs
from its send to its full answer, and a request is sent only while the
window is open.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from anns_bench.cell import load
from anns_bench.client import wire
from anns_bench.client.ranking import nearest_centroids
from anns_bench.hostdiag import Host

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
    """A mix bound to a configuration, a system and the run's queries.

    ``Traffic(mix, ...)`` builds the ``Route`` class of the mix's route
    module, a subclass that supplies what is particular to the route:
    ``_prepare`` (the bodies), ``_items(c)`` (what client ``c`` cycles
    through), ``_send(c, item, first)`` (one request; ``first`` marks a
    client's first warm-up request), ``_decode(r)`` (an answer as pool
    rows, ids and distances) and ``width`` (ids an answer holds a query).
    """

    def __new__(cls, mix: dict, *args, **kwargs):
        if cls is Traffic:
            cls = load("routes", mix["route"]).Route
        return super().__new__(cls)

    def __init__(self, mix: dict, config: dict, system, queries: np.ndarray,
                 seed: int, tracer, host: Optional[Host] = None):
        self.mix, self.config, self.system = mix, config, system
        self.queries = queries
        self.seed = seed
        self.tracer = tracer
        self.host = host or Host(time.monotonic())
        self.rows = int(mix["rows_per_request"])
        self.n_clients = int(mix["clients"])
        pr = config["protocol"]
        self.k, self.nprobe = int(pr["k"]), int(pr["nprobe"])
        self.coarse_probe = int(pr["coarse_probe"])
        self.rebuilt = 0
        self.warm_failed = 0
        self.entry = load("entries", mix["entry"]).Entry(system)
        self.handle = self.entry.handle

    def close(self) -> None:
        """Close the entry and drop every reference to the program."""
        self.entry.close()
        self.handle = self.system = None

    # -- set-up ----------------------------------------------------------------
    def prepare(self) -> None:
        """The client side's work before the window: the centroids (GET
        /query), each query's probes, and every request body."""
        st, _, body = self.handle("GET", "/query", BIN, b"")
        if st != 200:
            raise RuntimeError(f"GET /query answered {st}")
        _, (centroids,) = wire.decode(body)
        with self.host.part("probes"):
            self.probes = nearest_centroids(self.queries, centroids,
                                            self.nprobe)
        self._prepare()

    def _prepare(self) -> None:
        raise NotImplementedError

    def _items(self, c: int) -> List[int]:
        raise NotImplementedError

    def _send(self, c: int, item: int, first: bool = False):
        """(ok, answer) of one request."""
        raise NotImplementedError

    def _decode(self, r: Req):
        """(pool rows, ids, distances) of an answer; ValueError, KeyError,
        IndexError or TypeError where it is malformed."""
        raise NotImplementedError

    # -- warm-up -----------------------------------------------------------------
    def warm(self) -> None:
        """Synchronous requests of the cell's own kind before the window
        (a route may register a client's keys with its first one). A failed
        one is counted, not raised: the window's requests show what is
        wrong."""
        n = int(self.mix["warm_requests"])
        for c in range(self.n_clients):
            items = self._items(c)
            for w in range(n):
                ok, _ = self._send(c, items[w % len(items)], first=(w == 0))
                self.warm_failed += not ok

    # -- the window ----------------------------------------------------------------
    def run_window(self, t0: float, seconds: float, during=None) -> List[Req]:
        """Closed-loop clients from ``t0`` (time.monotonic) for ``seconds``;
        ``during`` runs on the calling thread meanwhile. The host's
        readings are taken as the clients start and once they have
        ended."""
        deadline = t0 + seconds
        out: List[List[Req]] = [[] for _ in range(self.n_clients)]
        errors: List[str] = []

        def client(c: int) -> None:
            items = self._items(c)
            i = 0
            while time.monotonic() < t0:
                time.sleep(0.0005)
            cpu0 = time.thread_time()
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
            self.host.threads[f"client {c}"] = [cpu0, time.thread_time()]

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(self.n_clients)]
        for t in threads:
            t.start()
        cpu0 = time.thread_time()
        self.host.snap("begin")
        if during is not None:
            during()
        for t in threads:
            t.join(timeout=seconds + 120)
        self.host.snap("end")
        self.host.threads["main"] = [cpu0, time.thread_time()]
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError("client failure: " + "; ".join(errors))
        return [r for rs in out for r in rs]

    # -- answers -----------------------------------------------------------------------
    def answers(self, reqs: List[Req]) -> Dict[str, np.ndarray]:
        """Decode the window's answers for the judge (client-side work,
        after the window): pool rows, ids and distances; ``failed`` counts
        the requests whose answer was an error, malformed or misshapen."""
        qidx, a_ids, a_d = [], [], []
        failed = 0
        for r in reqs:
            try:
                if not r.ok:
                    raise ValueError("error status")
                rows, ids, d = self._decode(r)
                if ids.shape != (len(rows), self.width) or d.shape != ids.shape:
                    raise ValueError("answer of the wrong shape")
            except (ValueError, KeyError, IndexError, TypeError):
                failed += 1
                continue
            qidx.append(rows)
            a_ids.append(ids)
            a_d.append(d)
        if not qidx:
            return {"qidx": np.empty(0, np.int64), "failed": failed,
                    "ids": np.empty((0, self.width), np.int64),
                    "dist": np.empty((0, self.width))}
        return {"qidx": np.concatenate(qidx), "failed": failed,
                "ids": np.concatenate(a_ids), "dist": np.concatenate(a_d)}
