"""Client CLI driver — the port of prefhetch_tpu/client/driver.py, the
reference's ``PreFHEtch_client`` main (reference: src/client/client.cpp:7-80):
run the fixed 8-stage pipeline, time stages 1-7 (the vector fetch is
deliberately outside the timed window, client.cpp:55-66), then print the
benchmark report in the JAX driver's exact format.

    python -m prefhetch_tpu_torch.client.driver --config cfg.json \
        --server http://HOST:PORT/
"""

from __future__ import annotations

import argparse

from prefhetch_tpu_torch.client.pipeline import ClientPipeline
from prefhetch_tpu_torch.serve.main import build_config
from prefhetch_tpu_torch.utils.logging import init_logger
from prefhetch_tpu_torch.utils.timer import StageTimer, Timer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="prefhetch_tpu_torch client")
    parser.add_argument("--config", help="PipelineConfig JSON file")
    parser.add_argument("--dataset-dir", help="directory with fvecs/ivecs files")
    parser.add_argument("--dataset-prefix", default="siftsmall")
    parser.add_argument("--server", default=None, help="server URL")
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args(argv)

    init_logger("prefhetch")
    logger = init_logger("prefhetch.client")
    cfg = build_config(args)
    client = ClientPipeline(cfg, server_addr=args.server)

    timer = Timer()
    stages = StageTimer()
    timer.start_timer()

    with stages.stage("1:get_query"):
        query = client.get_query()
    with stages.stage("2:get_centroids"):
        centroids = client.get_centroids()
    with stages.stage("3:sort_nearest_centroids"):
        _, sorted_cent = client.sort_nearest_centroids(query, centroids)
    with stages.stage("4:get_coarse_scores"):
        cs, ci, sizes = client.get_coarse_scores(sorted_cent, query)
    with stages.stage("5:compute_nearest_coarse_vectors"):
        sorted_coarse = client.compute_nearest_coarse_vectors(cs, ci, sizes)
    if cfg.protocol.encrypted_rerank:
        with stages.stage("6:get_encrypted_precise_scores"):
            ps, cand = client.get_encrypted_precise_scores(sorted_coarse, query)
    else:
        with stages.stage("6:get_precise_scores"):
            ps, cand = client.get_precise_scores(sorted_coarse, query)
    with stages.stage("7:compute_nearest_precise_vectors"):
        _, sorted_ids = client.compute_nearest_precise_vectors(ps, cand)

    timer.stop_timer()
    micros, millis = timer.get_duration()
    # reference prints exactly this split (client.cpp:55-66)
    logger.info("Time taken for client queries = %d us (%d ms)", micros, millis)
    for name, sec in stages.stages.items():
        logger.info("  stage %s: %.1f ms", name, sec * 1e3)

    # stage 8 — outside the timed window (client.cpp:55-66); real-PIR mode
    # dispatches like ClientPipeline.run() so the CLI never leaks indices
    if cfg.protocol.pir_mode == "he":
        _, top_ids = client.get_precise_vectors_real_pir(sorted_ids)
    else:
        _, top_ids = client.get_precise_vectors_pir(sorted_ids)

    # stage 9 — benchmark report (client_lib.cpp:243-337)
    rep = client.benchmark_results(top_ids)
    p = cfg.protocol
    i = cfg.index
    logger.info("Total Query Benchmark Results")
    logger.info(
        "Parameters: NPROBE = %d, COARSE_PROBE = %d, K = %d",
        p.nprobe, p.coarse_probe, p.k,
    )
    logger.info("Parameters: NQUERY = %d, NLIST = %d", p.nquery, i.nlist)
    logger.info(
        "Parameters: SUB_QUANTIZERS = %d, SUB_VECTOR_SIZE = %d",
        i.pq_m, i.pq_nbits,
    )
    logger.info(
        "Recall@1 = %g, Recall@10 = %g, Recall@100 = %g",
        rep.recall_1, rep.recall_10, rep.recall_100,
    )
    logger.info(
        "MRR@1 = %g, MRR@10 = %g, MRR@100 = %g",
        rep.mrr_1, rep.mrr_10, rep.mrr_100,
    )


if __name__ == "__main__":
    main()
