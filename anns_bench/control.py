"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16, the precision below the float32 the
configurations state. It has to come out as not correct.

    python3 -m anns_bench.control --workload <cell> --seed <n> [<n> ...]

For each seed: the cell's corpus and queries from the seed (data.py), the
queries a run of the cell answers, the answers the bfloat16 search gives
(ids and distances for /search; for the two-round traffic, the
bfloat16 top-COARSE_PROBE as candidates and their bfloat16 distances as
the decrypted ones), judged by judge.py against the configuration's limits.
Prints one JSON line a seed. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def queries_answered(cell, n_pool: int) -> np.ndarray:
    """Pool rows a run of the cell answers (traffic.py's batches)."""
    mix = cell.traffic
    if mix["route"] == "search":
        return np.arange(n_pool)
    rows, clients = int(mix["rows_per_request"]), int(mix["clients"])
    nb = int(mix["batches_per_client"])
    return np.unique(np.arange(clients * nb * rows) % n_pool)


def control_numbers(cell, seed: int, device) -> dict:
    from anns_bench import judge
    from anns_bench.data import make_sift_style
    from anns_bench.reference import Reference, bf16_distances, bf16_topk

    cfg = cell.config
    data = make_sift_style(cfg["dataset"], seed, device)
    ref = Reference(data["base"], device)
    qidx = queries_answered(cell, len(data["query"]))
    q = data["query"][qidx]
    k = int(cfg["protocol"]["k"])
    if cell.traffic["route"] == "search":
        ids, d = bf16_topk(ref, q, k)
        numbers, _ = judge.judge_search(ref, data["query"], qidx, ids, d, 0, k)
    else:
        cand, _ = bf16_topk(ref, q, int(cfg["protocol"]["coarse_probe"]))
        dec = bf16_distances(ref, q, cand)
        numbers, _ = judge.judge_rerank(ref, data["query"], qidx, cand, dec,
                                        0, k)
    correct, checks = judge.check(numbers, cfg["checks"])
    return {"seed": seed, "correct": correct, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    from anns_bench.cell import load_cell

    cell = load_cell(a.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for s in a.seed:
        print(json.dumps(control_numbers(cell, s, torch.device("cuda"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
