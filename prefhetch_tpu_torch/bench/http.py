"""The HTTP serving bench (bench.py ``http_serving_bench`` :1222-1436):
BASELINE config 5 through the real wire.

The engine serves from the native epoll frontend (``max_batch``,
``PFH_HTTP_GRACE_MS`` and ``PFH_HTTP_RESOLVERS`` as in bench.py); the
clients run in another process (``http_worker``) so that the interpreter
lock does not couple client and server work. Three closed-loop phases over
the binary wire, each a round trip a request:

- multiround — 64 clients: top-COARSE_PROBE /coarsesearch, then
  /precisesearch of those candidates (the reference's two rounds);
- allcand — 16 clients: the tiled /coarsesearch of every probed candidate,
  client-side selection, /precisesearch;
- fused — one pipelined connection a 16 clients: /search of 16 rows a
  request, PFH_HTTP_PIPE_DEPTH requests in flight (``http_qps``).

Before the phases, the worker holds the first /coarsesearch and /search
answers to the engine's own in-process answers.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from prefhetch_tpu_torch.bench.data import (
    COARSE_PROBE, K, NPROBE, BenchConfig,
)
from prefhetch_tpu_torch.bench.core import WORKER_TIMEOUT_S, run_worker


def _phase(line: str):
    v = line.split()
    return [float(x) for x in v[2:]], float(v[1]) - float(v[0])


def _pct(sorted_ms, p: float) -> float:
    return sorted_ms[min(len(sorted_ms) - 1, int(len(sorted_ms) * p))]


def http_serving_bench(cfg: BenchConfig, data, index, device,
                       n_clients: int = 256,
                       reqs_per_client: int = 30) -> dict:
    from prefhetch_tpu_torch.engine.server import QueryEngine
    from prefhetch_tpu_torch.serve.native_server import serve_forever_native
    from prefhetch_tpu_torch.utils.config import (
        PipelineConfig, ProtocolParams,
    )

    pcfg = PipelineConfig(
        index=cfg.index_params(),
        protocol=ProtocolParams(nprobe=NPROBE, coarse_probe=COARSE_PROBE,
                                k=K, nquery=1),
        nbase=cfg.nbase,
    )
    engine = QueryEngine(pcfg, device=device)
    engine.set_index(index, data["base"])
    n_clients = int(os.environ.get("PFH_HTTP_CLIENTS", n_clients))
    max_batch = int(os.environ.get("PFH_HTTP_MAXBATCH", 256))
    rows_req = int(os.environ.get("PFH_HTTP_ROWS_PER_REQ", "16"))
    centroids = index.centroids.cpu().numpy()
    queries = data["query"][: max(n_clients, 1)].astype(np.float32)
    d2 = ((queries[:, None, :] - centroids[None]) ** 2).sum(-1)
    probes = np.argsort(d2, axis=1)[:, :NPROBE].astype(np.int64)

    # every route once before the server's threads exist, and the answers
    # the worker's first requests must get
    wq, wp = queries[:1], probes[:1]
    topk_ids = engine.coarse_search_topk(wq, wp, COARSE_PROBE)[0]
    engine.coarse_search_tiled(wq, wp)
    engine.precise_search(wq, np.arange(COARSE_PROBE, dtype=np.int64)[None])
    rows = np.arange(rows_req) % len(queries)
    fused_ids = engine.search_fused(queries[rows], probes[rows], K)[0]
    # all-candidates qdist bytes a query on the wire
    wire_q = int(engine._serve_mt[NPROBE] * engine._tiled_view.tile * 2)

    srv = serve_forever_native(
        engine, port=0, background=True, max_batch=max_batch,
        grace_ms=float(os.environ.get("PFH_HTTP_GRACE_MS", 1.5)),
        n_resolvers=int(os.environ.get("PFH_HTTP_RESOLVERS", 3)),
    )
    try:
        with tempfile.TemporaryDirectory() as td:
            np.save(os.path.join(td, "queries.npy"), queries)
            np.save(os.path.join(td, "probes.npy"), probes)
            np.save(os.path.join(td, "topk_ids.npy"), topk_ids)
            np.save(os.path.join(td, "fused_ids.npy"), fused_ids)
            lines = run_worker(
                "prefhetch_tpu_torch.bench.http_worker",
                [f"http://127.0.0.1:{srv.port}/", td, n_clients,
                 reqs_per_client, COARSE_PROBE, rows_req],
                WORKER_TIMEOUT_S * 2,
            ).strip().split("\n")
        tm = srv.snapshot()
    finally:
        srv.shutdown()      # the server's threads never outlive the section

    lat, wall = _phase(lines[0])
    ac_lat, ac_wall = _phase(lines[1])
    fu_lat, fu_wall = _phase(lines[2])
    lat_ms = sorted(x * 1e3 for x in lat)
    ac_ms = sorted(x * 1e3 for x in ac_lat)
    fu_ms = sorted(x * 1e3 for x in fu_lat)
    # http_qps is the production route, the fused one-round /search;
    # multiround is the reference's two round trips, allcand its
    # all-candidates wire
    return {
        "http_clients": n_clients,
        "http_topk_wire_bytes_per_query": COARSE_PROBE * 8,
        "http_allcand_wire_bytes_per_query": wire_q,
        "http_multiround_qps": len(lat) / wall,
        "http_multiround_p50_ms": _pct(lat_ms, 0.5),
        "http_multiround_p99_ms": _pct(lat_ms, 0.99),
        "http_frontend": "native",
        # host seconds and counts of each serving phase over the run
        "http_server_phases": {k: v for k, v in tm.items()
                               if isinstance(v, (int, float))},
        "http_mean_wave": tm["rows"] / max(tm["waves"], 1),
        "http_allcand_qps": len(ac_lat) / ac_wall,
        "http_allcand_p50_ms": _pct(ac_ms, 0.5),
        "http_qps": len(fu_lat) * rows_req / fu_wall,
        "http_rows_per_req": rows_req,
        "http_p50_ms": _pct(fu_ms, 0.5),
        "http_p99_ms": _pct(fu_ms, 0.99),
    }
