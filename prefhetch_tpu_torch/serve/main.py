"""Server entry point — the port of prefhetch_tpu/serve/main.py, the
reference's ``PreFHEtch_server`` main (reference: src/server/server.cpp:6-13):
init logger → build engine → train/load index → run web server.

    python -m prefhetch_tpu_torch.serve.main --config cfg.json \\
        [--dataset-dir DIR --dataset-prefix P] [--port N] \\
        [--frontend auto|threaded|aio|native] [--device cuda|cpu] [--shard]

The engine runs on the card (``--device cuda``, the default) and refuses to
start without one unless ``--device cpu`` is given. ``--shard`` shards the
index across every visible device of that type once it is loaded (a mesh of
one on a one-card machine or on the CPU; parallel/mesh.py). ``--frontend auto`` is
the native epoll frontend; a failed native build is an error, not a switch
to another frontend.
"""

from __future__ import annotations

import argparse
import os

from prefhetch_tpu_torch.engine.server import QueryEngine
from prefhetch_tpu_torch.utils.config import PipelineConfig, REFERENCE_PRESET
from prefhetch_tpu_torch.utils.logging import init_logger


def build_config(args) -> PipelineConfig:
    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
    else:
        cfg = REFERENCE_PRESET
    if args.dataset_dir:
        prefix = args.dataset_prefix
        cfg = PipelineConfig(
            index=cfg.index,
            protocol=cfg.protocol,
            he=cfg.he,
            nbase=cfg.nbase,
            train_path=os.path.join(args.dataset_dir, f"{prefix}_learn.fvecs"),
            base_path=os.path.join(args.dataset_dir, f"{prefix}_base.fvecs"),
            query_path=os.path.join(args.dataset_dir, f"{prefix}_query.fvecs"),
            groundtruth_path=os.path.join(
                args.dataset_dir, f"{prefix}_groundtruth.ivecs"
            ),
            host=cfg.host,
            port=args.port or cfg.port,
        )
    return cfg


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="prefhetch_tpu_torch server")
    parser.add_argument("--config", help="PipelineConfig JSON file")
    parser.add_argument("--dataset-dir", help="directory with fvecs/ivecs files")
    parser.add_argument("--dataset-prefix", default="siftsmall")
    parser.add_argument("--index-dir", default=".", help="index artifact cache dir")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the engine: cuda (default) or cpu",
    )
    parser.add_argument(
        "--batching", action="store_true",
        help="coalesce concurrent requests into shared device batches "
             "(threaded and aio frontends; the native one batches waves)",
    )
    parser.add_argument(
        "--shard", action="store_true",
        help="shard the index across all visible devices (mesh mode)",
    )
    parser.add_argument(
        "--frontend", choices=("auto", "threaded", "aio", "native"),
        default="auto",
        help="web layer: auto = native (the C++ epoll frontend, "
             "native/pfh_http.cpp); threaded = the stdlib server; aio = "
             "the asyncio loop",
    )
    args = parser.parse_args(argv)

    init_logger("prefhetch")  # parent logger: engine/serve children propagate
    logger = init_logger("prefhetch.server")
    cfg = build_config(args)
    logger.info(
        "Preparing index with precise dimension d=%d", cfg.index.d
    )
    try:
        engine = QueryEngine.get_instance(cfg, index_dir=args.index_dir,
                                          device=args.device)
    except RuntimeError as e:
        parser.exit(2, f"error: {e}\n")
    engine.init_index()
    if args.shard:
        engine.enable_sharding()
    port = args.port or cfg.port
    frontend = "native" if args.frontend == "auto" else args.frontend
    logger.info("frontend %s on %s", frontend, engine.device)
    if frontend == "native":
        from prefhetch_tpu_torch.serve.native_server import (
            serve_forever_native,
        )

        serve_forever_native(engine, cfg.host, port)
    elif frontend == "aio":
        from prefhetch_tpu_torch.serve.aio_server import serve_forever_aio

        serve_forever_aio(engine, cfg.host, port, batching=args.batching)
    else:
        from prefhetch_tpu_torch.serve.http_server import serve_forever

        serve_forever(engine, cfg.host, port, batching=args.batching)


if __name__ == "__main__":
    main()
