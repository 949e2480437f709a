"""``"search"``: the fused triage round, one binary ``/search`` a request.

The 10K-query pool is cut into the same batches for every seed, and the
seed orders them; each client cycles through its share, and the warm-up
sends every batch once. An answer is the k nearest ids and their
distances, nearest first.
"""

from __future__ import annotations

import numpy as np

from anns_bench.client import wire
from anns_bench.judge import judge_search as judge  # noqa: F401
from anns_bench.reference import bf16_topk
from anns_bench.traffic import BIN, Traffic


class Route(Traffic):
    def _prepare(self) -> None:
        n = len(self.queries)
        nb = -(-n // self.rows)
        self.batch_rows = [(b * self.rows + np.arange(self.rows)) % n
                           for b in range(nb)]
        self.bodies = [self._search_body(r) for r in self.batch_rows]
        # the same batches for every seed; the seed orders them
        self.order = np.random.default_rng(
            self.seed % (1 << 63)).permutation(nb)

    def _search_body(self, rows: np.ndarray) -> bytes:
        return wire.encode(wire.KIND_SEARCH_REQ, [
            self.queries[rows], self.probes[rows],
            np.asarray([self.k], np.uint32)])

    def _send_search(self, c: int, b: int):
        st, _, resp = self.tracer.timed("handle:/search", self.handle,
                                        "POST", "/search", BIN, self.bodies[b])
        return st == 200, resp

    def _items(self, c: int):
        return [int(b) for b in self.order[c::self.n_clients]]

    def _send(self, c: int, item: int, first: bool = False):
        return self._send_search(c, item)

    @property
    def width(self) -> int:
        return self.k

    def _decode(self, r):
        kind, secs = wire.decode(r.answer)
        if kind != wire.KIND_SEARCH or len(secs) != 2:
            raise ValueError("not a /search answer")
        rows = self.batch_rows[r.item]
        return rows, secs[0].astype(np.int64), secs[1].astype(np.float64)


def answered(mix: dict, n_pool: int) -> np.ndarray:
    """Every pool row: the window sends every batch."""
    return np.arange(n_pool)


def control(ref, queries: np.ndarray, config: dict):
    """The bfloat16 search's top k, ids and distances."""
    return bf16_topk(ref, queries, int(config["protocol"]["k"]))
