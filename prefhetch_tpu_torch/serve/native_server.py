"""Native epoll frontend with a per-wave Python serving loop — the port of
prefhetch_tpu/serve/native_server.py.

The C++ side (native/pfh_http.cpp, the counterpart of the reference's Drogon
event loop, src/server/server_lib.cpp:48-53) owns every socket: accept,
HTTP/1.1 keep-alive parsing, response writes, and the wait for arrivals.
Python wakes up once per WAVE of requests:

    poll() → group by (route, kind, shape) → ONE engine call per group
           → a completion thread resolves it → encode + respond each

The hot binary routes are grouped (``_group_key``): ``ctopk`` (/coarsesearch
kind 9), ``ctiled`` (/coarsesearch kind 4), ``precise`` (/precisesearch
kind 5) and ``fused`` (/search kind 11). Each group makes one ``*_async``
engine call, which enqueues the device work and returns a resolver;
``n_resolvers`` completion threads call the resolvers, so the next wave is
decoded and enqueued while earlier ones finish. A group whose engine call
refuses its inputs falls back to the Dispatcher one request at a time;
every other route (the JSON wire, /encryptedsearch, GET routes) goes to the
Dispatcher on a two-thread pool, which stays the semantic authority.

The resolvers copy results with ``.cpu()``, which waits on the device's
default stream: a resolver waits for every wave enqueued before its copy,
so the completion threads overlap host work (encoding, responding) but not
device work.
"""

from __future__ import annotations

import ctypes
import logging
import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from prefhetch_tpu_torch import native
from prefhetch_tpu_torch.serve.handlers import BIN_CT, Dispatcher
from prefhetch_tpu_torch.utils import wire_bin

logger = logging.getLogger("prefhetch.serve")

_CT_JSON = 0
_CT_BIN = 1
# how long an idle poll waits for a first arrival before it checks for
# shutdown
_POLL_MS = 200.0


def _ct_code(ctype_str: str) -> int:
    return _CT_BIN if ctype_str.startswith(BIN_CT) else _CT_JSON


class _Req:
    __slots__ = (
        "req_id", "method", "path", "flags", "body", "kind", "secs", "rows",
    )

    def __init__(self, desc) -> None:
        self.req_id = desc.req_id
        self.method = desc.method.decode("ascii", "replace")
        self.path = desc.path.decode("ascii", "replace")
        self.flags = desc.flags
        if desc.body_len:
            # view into the C++-owned buffer (alive until respond): the
            # decode below makes zero-copy numpy views of the sections
            self.body = np.ctypeslib.as_array(
                desc.body, shape=(desc.body_len,)
            )
        else:
            self.body = np.empty(0, np.uint8)
        self.kind = -1
        self.secs: Optional[List[np.ndarray]] = None
        # query rows this request adds to a wave (the reference protocol
        # sends NQUERY rows a request, client_lib.cpp:83-208)
        self.rows = 1

    def decode_bin(self) -> bool:
        """Zero-copy binary decode; sets kind/secs/rows. False = malformed."""
        try:
            self.kind, self.secs = wire_bin.decode(self.body)
        except ValueError:
            return False
        if self.secs and getattr(self.secs[0], "ndim", 0) >= 1:
            self.rows = max(1, int(self.secs[0].shape[0]))
        return True


class NativeHTTPServer:
    """Serving loop over the native epoll frontend. ``port=0`` binds a free
    port (``.port``); ``shutdown()`` stops every thread and the socket."""

    def __init__(
        self,
        engine,
        port: int = 8080,
        max_batch: int = 64,
        grace_ms: float = 1.5,
        n_resolvers: int = 2,
    ) -> None:
        lib = native.http_lib()
        self._lib = lib
        self._h = lib.pfh_http_start(port, 256)
        if not self._h:
            raise OSError(f"pfh_http: cannot bind port {port}")
        self.port = int(lib.pfh_http_port(self._h))
        self.engine = engine
        self.dispatcher = Dispatcher(engine, frontend=self.snapshot)
        self._max_batch = max_batch
        self._grace_us = int(grace_ms * 1e3)
        self._poll_us = int(_POLL_MS * 1e3)
        self._descs = (native.ReqDesc * max_batch)()
        self._stop = threading.Event()
        # per-phase accumulators (seconds) and counts, read by /stats; every
        # thread adds to them through _count, under _inflight_lock
        self.timing = {
            "waves": 0, "reqs": 0, "rows": 0, "decode_s": 0.0,
            "dispatch_s": 0.0, "resolve_s": 0.0, "encode_s": 0.0,
            # slow_s: the dispatch thread handing requests to the slow
            # pool; slow_serve_s: the pool threads serving them
            "slow_s": 0.0, "slow_serve_s": 0.0, "poll_s": 0.0,
            "queue_s": 0.0,
            "cut_full": 0, "cut_idle": 0,
            # most completion threads inside a resolver at once: whether
            # the resolvers overlap
            "resolving_max": 0,
        }
        self._resolving = 0
        # one engine call per group: the count a kernel's launches are
        # held to (one K1 launch per "fused" call)
        self.group_calls: Counter = Counter()
        self.slow_reqs = 0
        # n_resolvers waves resolve at once; the bounded queue is
        # backpressure: when the device falls behind, put() blocks,
        # arrivals pile up in the C++ ready queue and the next poll drains
        # them as one larger wave
        self._n_resolvers = max(1, int(n_resolvers))
        self._cq: "queue.Queue" = queue.Queue(maxsize=self._n_resolvers)
        # waves past dispatch (queued or resolving): a wave is cut early
        # only when the pipeline could take it at once
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._cthreads = [
            threading.Thread(
                target=self._completion_loop,
                name=f"pfh-native-complete-{i}", daemon=True,
            )
            for i in range(self._n_resolvers)
        ]
        for t in self._cthreads:
            t.start()
        # non-wave routes run off the dispatch thread, so that a heavy
        # request (an encrypted re-rank) does not stall the hot waves
        self._slow_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="pfh-native-slow"
        )
        self._thread = threading.Thread(
            target=self._loop, name="pfh-native-serve", daemon=True
        )
        self._thread.start()

    def snapshot(self) -> dict:
        """The frontend's counters for GET /stats."""
        with self._inflight_lock:
            snap = {"name": "native", **self.timing,
                    "group_calls": dict(self.group_calls),
                    "slow_reqs": self.slow_reqs,
                    "n_resolvers": self._n_resolvers,
                    "max_batch": self._max_batch}
        snap["mean_rows_per_wave"] = snap["rows"] / max(snap["waves"], 1)
        return snap

    def _count(self, **delta) -> None:
        with self._inflight_lock:
            for key, v in delta.items():
                self.timing[key] += v

    # -- lifecycle -------------------------------------------------------
    def shutdown(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        # the dispatch thread is done: every queued job precedes the
        # sentinels, so joining the completion threads drains all responses
        for _ in self._cthreads:
            self._cq.put(None)
        for t in self._cthreads:
            t.join(timeout=30.0)
        self._slow_pool.shutdown(wait=True)
        self._lib.pfh_http_stop(self._h)
        self._h = None

    # -- serving loop ----------------------------------------------------
    def _loop(self) -> None:
        """Adaptive-wave dispatch loop: arrivals accumulate while the
        pipeline is busy, and a wave is cut when it is full, or when the
        pipeline could take it at once and a short grace has passed with no
        new arrival — so wave N+1 holds everything that arrived while wave N
        resolved."""
        lib, h = self._lib, self._h
        pending: "deque[_Req]" = deque()
        pending_rows = 0
        while not self._stop.is_set():
            if pending_rows < self._max_batch:
                wait = self._grace_us if pending else self._poll_us
                t_poll = time.perf_counter()
                n = lib.pfh_http_poll(h, self._descs, self._max_batch,
                                      wait, 0)
                self._count(poll_s=time.perf_counter() - t_poll)
                got = n > 0
                for i in range(n):
                    r = _Req(self._descs[i])
                    # decode now: the wave cap counts query ROWS
                    if r.method == "POST" and (r.flags & 1):
                        if not r.decode_bin():
                            self._respond_error(r, 400, "bad binary request")
                            continue
                    pending.append(r)
                    pending_rows += r.rows
            else:
                got = False
            if not pending:
                continue
            if pending_rows < self._max_batch:
                if got:
                    continue        # still arriving — keep collecting
                with self._inflight_lock:
                    busy = self._inflight > self._n_resolvers
                if busy:
                    continue        # resolvers busy — let the wave grow
                self._count(cut_idle=1)
            else:
                self._count(cut_full=1)
            # cut a prefix whose rows fit the wave; the remainder opens the
            # next one (multi-row requests never split)
            reqs: List[_Req] = []
            rows_t = 0
            while pending and rows_t + pending[0].rows <= self._max_batch:
                r = pending.popleft()
                reqs.append(r)
                rows_t += r.rows
            if not reqs:        # one request wider than the wave cap
                reqs.append(pending.popleft())
            pending_rows -= sum(r.rows for r in reqs)
            t0 = time.perf_counter()
            try:
                self._serve_batch(reqs, t0)
            except Exception:   # noqa: BLE001 — the loop must survive
                logger.exception("native serve batch failed")
                for r in reqs:
                    self._respond_error(r, 500, "internal error")

    def _respond(self, req: _Req, status: int, ctype: int,
                 body: bytes) -> None:
        self._lib.pfh_http_respond(
            self._h, req.req_id, status, ctype, body, len(body)
        )

    def _respond_error(self, req: _Req, status: int, msg: str) -> None:
        try:
            self._respond(
                req, status, _CT_JSON,
                b'{"error": "' + msg.encode()[:200] + b'"}',
            )
        except Exception:   # noqa: BLE001 — answering must not kill a loop
            logger.exception("native respond failed")

    def _serve_batch(self, reqs: List[_Req], t0: float) -> None:
        groups: Dict[Tuple, List[_Req]] = {}
        slow: List[_Req] = []
        for r in reqs:
            key = None
            if r.secs is not None:      # binary-decoded at poll time
                try:
                    key = self._group_key(r)
                except (IndexError, ValueError):
                    key = None
            if key is None:
                slow.append(r)
            else:
                groups.setdefault(key, []).append(r)
        t_dec = time.perf_counter()
        dispatch_s = 0.0
        for key, members in groups.items():
            try:
                dispatch_s += self._serve_group(key, members)
            except (ValueError, KeyError, IndexError, TypeError):
                # a poisoned group (e.g. k above ONE request's candidate
                # count) must not fail the whole wave: retry singly through
                # the dispatcher's full validation
                logger.warning(
                    "group %s (%d reqs) fell to the slow path",
                    key[0], len(members), exc_info=True,
                )
                slow.extend(members)
        t_grp = time.perf_counter()
        for r in slow:
            # copy the body OUT of the C++-owned buffer before leaving the
            # wave: the pool task may outlive this poll round
            self._slow_pool.submit(self._serve_slow, r, r.body.tobytes())
        t_end = time.perf_counter()
        # the whole wave's counts at once, so /stats never shows half a wave
        self._count(waves=1, reqs=len(reqs), rows=sum(r.rows for r in reqs),
                    decode_s=t_dec - t0, dispatch_s=dispatch_s,
                    slow_s=t_end - t_grp)
        self.dispatcher.stats.record(
            f"BATCH n={len(reqs)}", t_end - t0, True
        )

    @staticmethod
    def _group_key(r: _Req) -> Optional[Tuple]:
        s = r.secs
        two_d = len(s) >= 2 and s[0].ndim == 2 and s[1].ndim == 2
        if not two_d:
            return None
        if r.path == "/coarsesearch" and len(s) == 3 \
                and r.kind == wire_bin.KIND_COARSE_TOPK_REQ:
            return ("ctopk", s[0].shape[1], s[1].shape[1],
                    int(np.asarray(s[2]).reshape(-1)[0]))
        if r.path == "/coarsesearch" and len(s) == 2 \
                and r.kind == wire_bin.KIND_COARSE_REQ:
            return ("ctiled", s[0].shape[1], s[1].shape[1])
        if r.path == "/precisesearch" and len(s) == 2 \
                and r.kind == wire_bin.KIND_PRECISE_REQ:
            return ("precise", s[0].shape[1], s[1].shape[1])
        if r.path == "/search" and len(s) == 3 \
                and r.kind == wire_bin.KIND_SEARCH_REQ:
            return ("fused", s[0].shape[1], s[1].shape[1],
                    int(np.asarray(s[2]).reshape(-1)[0]))
        return None

    def _serve_group(self, key: Tuple, members: List[_Req]) -> float:
        """Enqueue a coalesced group on the device and hand its resolver to
        a completion thread; returns the seconds the engine call took.
        Inputs are checked here as the Dispatcher checks them; a refusal
        sends the group to the slow path."""
        t0 = time.perf_counter()
        if any(m.secs[0].shape[0] != m.secs[1].shape[0] for m in members):
            raise ValueError("query/index rows mismatch")
        rows = [int(m.secs[0].shape[0]) for m in members]
        q = np.concatenate([m.secs[0] for m in members]).astype(
            np.float32, copy=False
        )
        second = np.concatenate([m.secs[1] for m in members]).astype(
            np.int64, copy=False
        )
        route = key[0]
        if route == "precise":
            if second.min() < 0 or second.max() >= self.engine.base.shape[0]:
                raise ValueError("vector index out of range")
            resolver = self.engine.precise_search_async(q, second)
        else:
            if second.min() < 0 or second.max() >= self.engine.index.nlist:
                raise ValueError("centroid index out of range")
            if route == "ctiled":
                resolver = self.engine.coarse_search_tiled_async(q, second)
            else:
                k = key[3]
                if not 0 < k <= 1 << 20:
                    raise ValueError("bad k")
                if route == "ctopk":
                    resolver = self.engine.coarse_search_topk_async(
                        q, second, k)
                else:
                    resolver = self.engine.search_fused_async(q, second, k)
        t1 = time.perf_counter()
        with self._inflight_lock:
            self._inflight += 1
            self.group_calls[route] += 1
        self._cq.put((route, members, rows, resolver, time.perf_counter()))
        return t1 - t0

    # -- completion threads ------------------------------------------------
    def _completion_loop(self) -> None:
        # resolve_s sums THREAD seconds: overlapped waves count twice
        tm = self.timing
        while True:
            job = self._cq.get()
            if job is None:
                return
            route, members, rows, resolver, t_enq = job
            try:
                t0 = time.perf_counter()
                with self._inflight_lock:
                    self._resolving += 1
                    tm["resolving_max"] = max(tm["resolving_max"],
                                              self._resolving)
                try:
                    out = resolver()
                except Exception:   # noqa: BLE001 — the loop must survive
                    logger.exception("native resolve failed (%s)", route)
                    for m in members:
                        self._respond_error(m, 500, "internal error")
                    continue
                finally:
                    with self._inflight_lock:
                        self._resolving -= 1
                t1 = time.perf_counter()
                try:
                    self._encode_respond(route, members, rows, out)
                except Exception:   # noqa: BLE001
                    logger.exception("native encode failed (%s)", route)
                    for m in members:
                        self._respond_error(m, 500, "internal error")
                t2 = time.perf_counter()
                self._count(queue_s=t0 - t_enq, resolve_s=t1 - t0,
                            encode_s=t2 - t1)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def _serve_slow(self, r: _Req, body: bytes) -> None:
        t0 = time.perf_counter()
        try:
            status, ctype, out = self.dispatcher.handle(
                r.method, r.path,
                {
                    "content-type": BIN_CT if (r.flags & 1) else "",
                    "accept": BIN_CT if (r.flags & 2) else "",
                },
                body,
            )
        except Exception:   # noqa: BLE001 — the pool thread must survive
            logger.exception("native slow route failed (%s)", r.path)
            status, ctype, out = 500, "", b'{"error": "internal error"}'
        # counted before the answer goes out, so a client holding it finds
        # it in /stats
        with self._inflight_lock:
            self.timing["slow_serve_s"] += time.perf_counter() - t0
            self.slow_reqs += 1
        try:
            self._respond(r, status, _ct_code(ctype), out)
        except Exception:   # noqa: BLE001
            logger.exception("native respond failed")

    def _respond_multi(self, members: List[_Req], buf: np.ndarray,
                       offsets: np.ndarray) -> None:
        """One FFI call and one eventfd wake for the whole group."""
        ids = np.array([m.req_id for m in members], np.uint64)
        sts = np.full(len(members), 200, np.int32)
        self._lib.pfh_http_respond_multi(
            self._h, len(members),
            ids.ctypes.data_as(ctypes.c_void_p),
            sts.ctypes.data_as(ctypes.c_void_p),
            _CT_BIN,
            buf.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p),
        )

    def _encode_respond(self, route: str, members: List[_Req],
                        rows: List[int], out) -> None:
        if route == "ctopk":
            ids, dists, counts = out
            secs = [
                ids.astype(np.int32, copy=False),
                dists.astype(np.float32, copy=False),
                counts.astype(np.int64, copy=False),
            ]
            kind = wire_bin.KIND_COARSE_TOPK
        elif route == "ctiled":
            tile_idx, qdist, dmin, dstep, counts = out
            secs = [
                tile_idx.astype(np.int32, copy=False),
                qdist,
                dmin.astype(np.float32, copy=False),
                dstep.astype(np.float32, copy=False),
                counts.astype(np.int64, copy=False),
            ]
            kind = wire_bin.KIND_COARSE_TILED
        elif route == "precise":
            secs = [np.asarray(out, np.float32)]
            kind = wire_bin.KIND_PRECISE
        else:   # fused
            ids, dists = out
            secs = [
                ids.astype(np.int64, copy=False),
                dists.astype(np.float32, copy=False),
            ]
            kind = wire_bin.KIND_SEARCH
        buf, offsets = wire_bin.encode_rows(kind, secs, rows)
        self._respond_multi(members, buf, offsets)


def serve_forever_native(
    engine,
    host: str = "0.0.0.0",
    port: int = 8080,
    background: bool = False,
    max_batch: int = 64,
    grace_ms: float = 1.5,
    n_resolvers: int = 2,
) -> NativeHTTPServer:
    """Start the native frontend (binds every address; ``host`` is accepted
    for signature parity with serve_forever_aio). Returns the server when
    ``background``; else serves until interrupted, then shuts down."""
    srv = NativeHTTPServer(
        engine, port=port, max_batch=max_batch, grace_ms=grace_ms,
        n_resolvers=n_resolvers,
    )
    logger.info("native epoll frontend listening on :%d", srv.port)
    if background:
        return srv
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
    return srv
