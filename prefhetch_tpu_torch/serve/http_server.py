"""Threaded HTTP frontend — the port of prefhetch_tpu/serve/http_server.py,
the reference's Drogon web layer in stdlib form.

The reference's four routes and JSON field names (reference:
src/server/controllers/Query.h:14-31, Query.cc:10-127; SURVEY.md §2.2):

| route                 | method | request fields                                  | response fields |
|-----------------------|--------|------------------------------------------------|-----------------|
| /query                | GET    | —                                              | bare [nlist][d] float array |
| /coarsesearch         | POST   | preciseQuery, nearestCentroidIndexes            | coarseDistanceScores, coarseVectorIndexes, listSizesPerQuery |
| /precisesearch        | POST   | preciseQuery, nearestCoarseVectorIndexes        | preciseDistanceScores |
| /precise-vector-pir   | POST   | nearestPreciseVectorIndexes                     | queryResults |

Route logic lives in serve/handlers.py, shared with the asyncio and native
epoll frontends; this one (one OS thread per connection) is the portable
frontend and the reference-parity test surface. Malformed requests get
400s, where the reference parses every body unconditionally.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from prefhetch_tpu_torch.serve.handlers import Dispatcher

logger = logging.getLogger("prefhetch.serve")


class _Handler(BaseHTTPRequestHandler):
    dispatcher: Dispatcher = None  # injected by make_server
    protocol_version = "HTTP/1.1"

    # quiet default request logging
    def log_message(self, fmt, *args):  # noqa: N802
        logger.debug(fmt, *args)

    def _respond(self, status: int, ctype: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, method: str) -> None:
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        headers = {k.lower(): v for k, v in self.headers.items()}
        status, ctype, payload = self.dispatcher.handle(
            method, self.path, headers, body
        )
        self._respond(status, ctype, payload)

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")


def wrap_batching(engine, max_batch: int = 64, max_wait_ms: float = 8.0):
    """Interpose the cross-request BatchScheduler (serve/batcher.py) so
    concurrent requests share device batches."""
    from prefhetch_tpu_torch.serve.batcher import BatchScheduler

    return BatchScheduler(engine, max_batch=max_batch,
                          max_wait_ms=max_wait_ms)


def make_server(
    engine,
    host: str = "0.0.0.0",
    port: int = 8080,
    batching: bool = False,
    max_batch: int = 64,
    max_wait_ms: float = 8.0,
) -> ThreadingHTTPServer:
    """batching=True interposes the cross-request BatchScheduler; max_wait_ms
    is its coalescing window (requests arriving within it join the same
    device batch). ``port=0`` binds a free port (``server_address[1]``)."""
    if batching:
        engine = wrap_batching(engine, max_batch, max_wait_ms)
    disp = Dispatcher(engine, frontend=lambda: {"name": "threaded"})
    handler = type("BoundHandler", (_Handler,), {"dispatcher": disp})
    srv = ThreadingHTTPServer((host, port), handler, bind_and_activate=False)
    # stdlib default listen backlog is 5 — bursts of concurrent clients get
    # connection resets under batched serving; raise it
    srv.request_queue_size = 128
    try:
        srv.server_bind()
        srv.server_activate()
    except OSError:
        srv.server_close()
        raise
    return srv


def serve_forever(
    engine,
    host: str = "0.0.0.0",
    port: int = 8080,
    background: bool = False,
    batching: bool = False,
    max_wait_ms: float = 8.0,
) -> Optional[ThreadingHTTPServer]:
    """Run the web server (reference: Server::run_webserver,
    src/server/server_lib.cpp:48-53). background=True returns the server
    with a daemon thread serving it; ``shutdown()`` then
    ``server_close()`` stop it."""
    srv = make_server(engine, host, port, batching=batching,
                      max_wait_ms=max_wait_ms)
    logger.info("Server listening on %s:%d", host, srv.server_address[1])
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
    return None
