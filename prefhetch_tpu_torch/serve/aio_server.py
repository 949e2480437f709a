"""Asyncio event-loop HTTP frontend — the port of
prefhetch_tpu/serve/aio_server.py.

The reference serves from Drogon's epoll event loop
(src/server/server_lib.cpp:48-53). Here one asyncio loop owns every socket,
parses HTTP/1.1 keep-alive requests with two bytes.find calls, and hands
each complete (method, path, headers, body) to the shared Dispatcher
(serve/handlers.py) on a thread pool: engine calls block (device work, or a
batcher future), and the loop keeps draining sockets meanwhile. The C++
epoll frontend (serve/native_server.py) moves the byte handling off the
interpreter entirely; this pure-Python loop is the portable middle tier.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from prefhetch_tpu_torch.serve.handlers import Dispatcher

logger = logging.getLogger("prefhetch.serve")

_MAX_BODY = 1 << 30
_STATUS_LINE = {
    200: b"HTTP/1.1 200 OK\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    405: b"HTTP/1.1 405 Method Not Allowed\r\n",
    409: b"HTTP/1.1 409 Conflict\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    501: b"HTTP/1.1 501 Not Implemented\r\n",
}


class AioHTTPServer:
    """Minimal HTTP/1.1 keep-alive server on asyncio streams."""

    def __init__(
        self,
        engine,
        host: str = "0.0.0.0",
        port: int = 8080,
        executor_workers: int = 64,
    ) -> None:
        self.dispatcher = Dispatcher(engine, frontend=self._snapshot)
        self.host = host
        self.port = port
        # engine calls block (device dispatch or batcher future); park them
        # on a pool so the event loop keeps draining sockets
        self._pool = ThreadPoolExecutor(max_workers=executor_workers)
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    def _snapshot(self) -> dict:
        return {"name": "aio"}

    # -- connection handling --------------------------------------------
    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                except asyncio.LimitOverrunError:
                    break
                try:
                    method, path, headers = self._parse_head(head)
                except ValueError:
                    writer.write(
                        _STATUS_LINE[400] + b"Content-Length: 0\r\n\r\n"
                    )
                    await writer.drain()
                    break
                length = int(headers.get("content-length", 0))
                if length > _MAX_BODY:
                    break
                body = await reader.readexactly(length) if length else b""
                loop = asyncio.get_running_loop()
                status, ctype, payload = await loop.run_in_executor(
                    self._pool, self.dispatcher.handle,
                    method, path, headers, body,
                )
                status_line = _STATUS_LINE.get(
                    status, f"HTTP/1.1 {status} X\r\n".encode()
                )
                writer.write(
                    status_line
                    + b"Content-Type: " + ctype.encode()
                    + b"\r\nContent-Length: " + str(len(payload)).encode()
                    + b"\r\n\r\n"
                )
                writer.write(payload)
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    def _parse_head(head: bytes):
        # request line
        eol = head.find(b"\r\n")
        if eol < 0:
            raise ValueError("bad request line")
        parts = head[:eol].split(b" ")
        if len(parts) != 3:
            raise ValueError("bad request line")
        method = parts[0].decode("latin1")
        path = parts[1].decode("latin1")
        if "?" in path:
            path = path.split("?", 1)[0]
        headers = {}
        for line in head[eol + 2 : -4].split(b"\r\n"):
            c = line.find(b":")
            if c > 0:
                headers[line[:c].decode("latin1").strip().lower()] = (
                    line[c + 1 :].decode("latin1").strip()
                )
        return method, path, headers

    # -- lifecycle -------------------------------------------------------
    async def _start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port,
            backlog=256, limit=1 << 20,
        )
        # port=0 binds a free port: report the one bound
        self.port = self._server.sockets[0].getsockname()[1]

    def run_forever(self) -> None:
        """Blocking serve (reference: drogon::app().run())."""
        asyncio.run(self._run())

    async def _run(self) -> None:
        await self._start()
        async with self._server:
            await self._server.serve_forever()

    def start_background(self) -> None:
        """Run the loop on a daemon thread (tests); ``shutdown()`` stops
        it."""
        started = threading.Event()
        failed: list = []

        def _thread_main() -> None:
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._start())
            except OSError as e:          # cannot bind
                failed.append(e)
                self._loop.close()
                return
            finally:
                started.set()
            try:
                self._loop.run_forever()
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=_thread_main, daemon=True)
        self._thread.start()
        if not started.wait(timeout=30):
            raise RuntimeError("asyncio server failed to start")
        if failed:
            self._pool.shutdown(wait=False)
            raise failed[0]

    async def _close(self) -> None:
        """Stop listening, cancel every connection's task and wait for
        them, then stop the loop."""
        self._server.close()
        tasks = [t for t in asyncio.all_tasks()
                 if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._loop.stop()

    def shutdown(self) -> None:
        if self._loop is not None and self._loop.is_running():
            asyncio.run_coroutine_threadsafe(self._close(), self._loop)
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)


def serve_forever_aio(
    engine,
    host: str = "0.0.0.0",
    port: int = 8080,
    background: bool = False,
    batching: bool = False,
    max_batch: int = 64,
    max_wait_ms: float = 8.0,
) -> Optional[AioHTTPServer]:
    """Asyncio twin of serve/http_server.serve_forever."""
    if batching:
        from prefhetch_tpu_torch.serve.http_server import wrap_batching

        engine = wrap_batching(engine, max_batch, max_wait_ms)
    srv = AioHTTPServer(engine, host, port)
    logger.info("Asyncio server listening on %s:%d", host, port)
    if background:
        srv.start_background()
        return srv
    srv.run_forever()
    return None
