"""Cross-request batching scheduler — the port of
prefhetch_tpu/serve/batcher.py.

Concurrent HTTP requests are coalesced into one device batch per service
(BASELINE config 5, "64-way batched serving"); the reference processes each
request on its own Drogon handler thread (SURVEY.md §2.4). One worker
thread per service: callers enqueue (payload, Future); the worker drains
the queue up to ``max_batch`` query rows (waiting at most ``max_wait_ms``
after the first arrival), concatenates
along the query axis, makes ONE engine call and splits the results back per
caller. Every engine service is row-independent, so the answers do not
depend on how requests were batched. A batch the engine refuses is run
again one caller at a time, so that one caller's bad input fails only that
caller (the JAX scheduler fails the whole batch). Host numpy only.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Tuple

import numpy as np


class _Service:
    def __init__(self, fn: Callable, split: Callable, max_batch: int,
                 max_wait_ms: float):
        self.fn = fn
        self.split = split
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[Tuple[tuple, Future]]" = queue.Queue()
        self.batches_run = 0
        self.rows_run = 0
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()

    def submit(self, *payload) -> Future:
        f: Future = Future()
        self.q.put((payload, f))
        return f

    def _loop(self):
        import time as _time

        carry = None
        while True:
            payload, fut = carry if carry is not None else self.q.get()
            carry = None
            batch = [(payload, fut)]
            rows = payload[0].shape[0]
            # full-window collect: keep draining until max_wait has elapsed
            # since the batch opened (or max_batch rows arrive). Draining
            # only-until-momentarily-empty dispatched ~5-row batches under
            # dribbling concurrent arrivals, paying a full device round trip
            # each; the window amortizes it across every in-flight client.
            t_open = _time.perf_counter()
            while rows < self.max_batch:
                remaining = self.max_wait - (_time.perf_counter() - t_open)
                if remaining <= 0:
                    break
                try:
                    p2, f2 = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                # only coalesce shape-compatible payloads (same trailing
                # dims — e.g. same nprobe / coarse_probe); defer others
                if any(
                    a.shape[1:] != b.shape[1:] for a, b in zip(p2, payload)
                ):
                    carry = (p2, f2)
                    break
                batch.append((p2, f2))
                rows += p2[0].shape[0]
            args = tuple(
                np.concatenate([b[0][i] for b in batch], axis=0)
                for i in range(len(payload))
            )
            try:
                out = self.fn(*args)
            except Exception as e:  # noqa: BLE001 — goes to the callers
                if len(batch) == 1:
                    fut.set_exception(e)
                    continue
                # one caller's input the engine refuses (k above its
                # candidate count) must not fail the others: run each
                # caller's rows alone
                for p, f in batch:
                    try:
                        f.set_result(self.split(self.fn(*p), 0,
                                                p[0].shape[0]))
                    except Exception as e1:  # noqa: BLE001
                        f.set_exception(e1)
                continue
            self.batches_run += 1
            self.rows_run += rows
            offset = 0
            for p, f in batch:
                n = p[0].shape[0]
                f.set_result(self.split(out, offset, n))
                offset += n


def _split_coarse(out, offset, n):
    scores, indexes, sizes = out
    start = int(sizes[:offset].sum())
    stop = start + int(sizes[offset : offset + n].sum())
    return scores[start:stop], indexes[start:stop], sizes[offset : offset + n]


def _split_rows(out, offset, n):
    return out[offset : offset + n]


def _split_row_tuple(out, offset, n):
    return tuple(a[offset : offset + n] for a in out)


class BatchScheduler:
    """Engine facade with cross-request batching. Exposes the same service
    signatures as QueryEngine, so the HTTP layer can use either."""

    def __init__(self, engine, max_batch: int = 64, max_wait_ms: float = 4.0):
        self.engine = engine
        self.config = engine.config
        self._coarse = _Service(
            engine.coarse_search, _split_coarse, max_batch, max_wait_ms,
        )
        self._precise = _Service(
            engine.precise_search, _split_rows, max_batch, max_wait_ms,
        )
        self._fetch = _Service(
            engine.precise_vector_pir, _split_rows, max_batch, max_wait_ms,
        )
        self._coarse_tiled = _Service(
            engine.coarse_search_tiled, _split_row_tuple, max_batch,
            max_wait_ms,
        )
        # server-select coarse top-k: one service PER k value (k is part of
        # the engine-call identity — the shape-compat check only compares
        # array shapes, so mixing k values in one queue would mis-coalesce)
        self._coarse_topk: dict = {}
        self._search_svc: dict = {}
        self._coarse_topk_lock = threading.Lock()
        self._batch_args = (max_batch, max_wait_ms)

    # passthroughs -------------------------------------------------------
    @property
    def index(self):
        return self.engine.index

    @property
    def base(self):
        return self.engine.base

    def retrieve_centroids(self):
        return self.engine.retrieve_centroids()

    def tile_table(self):
        return self.engine.tile_table()

    def encrypted_precise_search(self, *a, **kw):
        return self.engine.encrypted_precise_search(*a, **kw)

    def pir_fetch(self, *a, **kw):
        return self.engine.pir_fetch(*a, **kw)

    # batched services ----------------------------------------------------
    def coarse_search(self, precise_query, nearest_centroid_idx):
        return self._coarse.submit(
            np.asarray(precise_query), np.asarray(nearest_centroid_idx)
        ).result()

    def coarse_search_tiled(self, precise_query, nearest_centroid_idx):
        return self._coarse_tiled.submit(
            np.asarray(precise_query), np.asarray(nearest_centroid_idx)
        ).result()

    def coarse_search_topk(self, precise_query, nearest_centroid_idx, k):
        k = int(k)
        svc = self._coarse_topk.get(k)
        if svc is None:
            with self._coarse_topk_lock:
                svc = self._coarse_topk.get(k)
                if svc is None:
                    svc = _Service(
                        lambda q, p, _k=k: self.engine.coarse_search_topk(
                            q, p, _k
                        ),
                        _split_row_tuple, *self._batch_args,
                    )
                    self._coarse_topk[k] = svc
        return svc.submit(
            np.asarray(precise_query), np.asarray(nearest_centroid_idx)
        ).result()

    def search_fused(self, precise_query, nearest_centroid_idx, k):
        k = int(k)
        svc = self._search_svc.get(k)
        if svc is None:
            with self._coarse_topk_lock:
                svc = self._search_svc.get(k)
                if svc is None:
                    svc = _Service(
                        lambda q, p, _k=k: self.engine.search_fused(
                            q, p, _k
                        ),
                        _split_row_tuple, *self._batch_args,
                    )
                    self._search_svc[k] = svc
        return svc.submit(
            np.asarray(precise_query), np.asarray(nearest_centroid_idx)
        ).result()

    def precise_search(self, precise_query, nearest_coarse_vector_idx):
        return self._precise.submit(
            np.asarray(precise_query), np.asarray(nearest_coarse_vector_idx)
        ).result()

    def precise_vector_pir(self, ids):
        return self._fetch.submit(np.asarray(ids)).result()

    def stats(self) -> dict:
        return {
            name: {"batches": s.batches_run, "rows": s.rows_run}
            for name, s in [
                ("coarse", self._coarse),
                ("coarse_tiled", self._coarse_tiled),
                ("precise", self._precise),
                ("fetch", self._fetch),
            ]
        }
