"""Client farm of the HTTP serving bench (bench.py
``_HTTP_CLIENT_WORKER_SRC`` :1449-1701), run in its own process:

    python -m prefhetch_tpu_torch.bench.http_worker ADDR DIR N_CLIENTS \
        N_REQS COARSE_PROBE ROWS_PER_REQ

An external client's view of the binary wire (numpy and the port's wire
codec only): DIR holds queries.npy and probes.npy, and the answers the
first requests must get (topk_ids.npy, fused_ids.npy). Transport is a raw
keep-alive socket with a minimal HTTP/1.1 reader: per-request parsing in
http.client costs a share of the host the server needs. Request bytes that
are constant per client are built once. Prints one line a phase,
"<t_start> <t_end> <lat0> <lat1> ...": multiround, allcand, fused.
"""

from __future__ import annotations

import os
import re
import socket
import sys
import threading
import time
import urllib.parse

import numpy as np

from prefhetch_tpu_torch.utils import wire_bin

_CL_RE = re.compile(rb"[Cc]ontent-[Ll]ength:\s*(\d+)")


def raw_req(method: str, path: str, body: bytes = b"") -> bytes:
    ct = wire_bin.CONTENT_TYPE
    hdr = (
        f"{method} {path} HTTP/1.1\r\nHost: b\r\nAccept: {ct}\r\n"
        + (f"Content-Type: {ct}\r\n" if body else "")
        + f"Content-Length: {len(body)}\r\n\r\n"
    ).encode()
    return hdr + body


class Conn:
    """One keep-alive connection with a minimal response reader."""

    def __init__(self, host: str, port: int):
        self.s = socket.create_connection((host, port), timeout=600)
        self.s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = b""

    def _recv_more(self) -> None:
        chunk = self.s.recv(262144)
        if not chunk:
            raise RuntimeError("connection closed by server")
        self.buf += chunk

    def read_response(self) -> bytes:
        while True:
            i = self.buf.find(b"\r\n\r\n")
            if i >= 0:
                break
            self._recv_more()
        head = self.buf[:i]
        status = int(head.split(b" ", 2)[1])
        m = _CL_RE.search(head)
        need = i + 4 + (int(m.group(1)) if m else 0)
        while len(self.buf) < need:
            self._recv_more()
        data = self.buf[i + 4: need]
        self.buf = self.buf[need:]
        if status != 200:
            raise RuntimeError(f"-> {status}: {data[:200]!r}")
        return data

    def req_raw(self, raw: bytes) -> bytes:
        self.s.sendall(raw)
        return self.read_response()


def main(argv) -> int:
    addr, td = argv[0], argv[1]
    n_clients, n_reqs, cp, rows_req = (int(x) for x in argv[2:6])
    queries = np.load(os.path.join(td, "queries.npy"))
    probes = np.load(os.path.join(td, "probes.npy"))
    u = urllib.parse.urlparse(addr)
    enc = wire_bin.encode

    def connect() -> Conn:
        return Conn(u.hostname, u.port)

    # the shared static tile table (one download; all-candidates phase)
    boot = connect()
    _, (_, tids) = wire_bin.decode(boot.req_raw(raw_req("GET",
                                                        "/tiletable")))

    def q_of(i):
        return queries[i % len(queries)][None].astype(np.float32)

    def p_of(i):
        return probes[i % len(probes)][None].astype(np.int64)

    coarse_raw = [raw_req("POST", "/coarsesearch", enc(
        wire_bin.KIND_COARSE_TOPK_REQ,
        [q_of(i), p_of(i), np.asarray([cp], np.uint32)]))
        for i in range(n_clients)]
    allcand_raw = [raw_req("POST", "/coarsesearch", enc(
        wire_bin.KIND_COARSE_REQ, [q_of(i), p_of(i)]))
        for i in range(n_clients)]
    # multi-row /search requests: the reference batches NQUERY queries a
    # request, which spreads the per-request wire cost
    fused_raw = []
    for i in range(n_clients):
        rows = (i * rows_req + np.arange(rows_req)) % len(queries)
        fused_raw.append(raw_req("POST", "/search", enc(
            wire_bin.KIND_SEARCH_REQ,
            [queries[rows].astype(np.float32),
             probes[rows].astype(np.int64), np.asarray([100], np.uint32)])))

    def one_round(conn, ci):
        # server-side top-COARSE_PROBE, then the precise round
        _, (ids, _, _) = wire_bin.decode(conn.req_raw(coarse_raw[ci]))
        conn.req_raw(raw_req("POST", "/precisesearch", enc(
            wire_bin.KIND_PRECISE_REQ, [q_of(ci), ids.astype(np.int64)])))
        return ids

    def one_round_allcand(conn, ci):
        # padded u16 distances of every candidate, client-side selection
        _, (tile_idx, qdist, _, _, _) = wire_bin.decode(
            conn.req_raw(allcand_raw[ci]))
        qd = qdist[0]
        part = np.argpartition(qd, cp)[:cp]
        order = part[np.argsort(qd[part], kind="stable")]
        ids = tids[tile_idx[0]].reshape(-1)[order].astype(np.int64)[None]
        conn.req_raw(raw_req("POST", "/precisesearch", enc(
            wire_bin.KIND_PRECISE_REQ, [q_of(ci), ids])))

    # warm the wire, and hold the first answers to the engine's own
    ids = one_round(boot, 0)
    if not np.array_equal(ids, np.load(os.path.join(td, "topk_ids.npy"))):
        print("/coarsesearch top-k ids differ from the engine's",
              file=sys.stderr)
        return 1
    one_round_allcand(boot, 0)
    _, (ids, _) = wire_bin.decode(boot.req_raw(fused_raw[0]))
    if not np.array_equal(ids,
                          np.load(os.path.join(td, "fused_ids.npy"))):
        print("/search ids differ from the engine's", file=sys.stderr)
        return 1

    lats: list = []
    errors: list = []
    lock = threading.Lock()

    def run_threads(client, n_cl):
        del lats[:]
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_cl)]
        t_start = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_end = time.time()
        if errors:
            raise RuntimeError(f"{len(errors)} clients failed: {errors[0]}")
        return t_start, t_end, list(lats)

    def run_phase(fn, n_cl, n_rq):
        def client(ci):
            try:
                conn = connect()
                mine = []
                for _ in range(n_rq):
                    t0 = time.perf_counter()
                    fn(conn, ci)
                    mine.append(time.perf_counter() - t0)
                with lock:
                    lats.extend(mine)
            except Exception as e:      # reported after the join
                errors.append(repr(e))
        return run_threads(client, n_cl)

    def run_phase_pipelined(n_cl, n_rq, depth):
        """HTTP/1.1 pipelining, ``depth`` requests in flight a connection
        (the native frontend answers in request order); a request's latency
        includes its wait behind the window."""
        def client(ci):
            try:
                conn = connect()
                raw = fused_raw[ci % n_clients]
                sent, mine = [], []
                k = min(depth, n_rq)
                for _ in range(k):
                    conn.s.sendall(raw)
                    sent.append(time.perf_counter())
                for i in range(n_rq):
                    conn.read_response()
                    mine.append(time.perf_counter() - sent[i])
                    if i + k < n_rq:
                        conn.s.sendall(raw)
                        sent.append(time.perf_counter())
                with lock:
                    lats.extend(mine)
            except Exception as e:      # reported after the join
                errors.append(repr(e))
        return run_threads(client, n_cl)

    def line(phase):
        t0, t1, lat = phase
        return f"{t0:.6f} {t1:.6f} " + " ".join(f"{x:.6f}" for x in lat)

    print(line(run_phase(one_round, min(n_clients, 64), n_reqs)))
    print(line(run_phase(one_round_allcand, min(n_clients, 16), 4)))
    depth = int(os.environ.get("PFH_HTTP_PIPE_DEPTH", "4"))
    print(line(run_phase_pipelined(max(1, n_clients // rows_req),
                                   n_reqs * depth, depth)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
