"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16, the precision below the float32 the
configurations state. It has to come out as not correct.

    python3 -m anns_bench.control --workload <cell> --seed <n> [<n> ...]

For each seed: the cell's corpus and queries from the seed (data.py), the
queries a run of the cell answers, and the answers the bfloat16 reference
gives for them in the form of the cell's route (routes/<route>.py
``answered`` and ``control``: ids and distances for /search; for the
two-round traffic, the bfloat16 top-COARSE_PROBE as candidates and their
bfloat16 distances as the decrypted ones), held by the route's judge to
the configuration's limits. Prints one JSON line a seed. The benchmark's
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys


def control_numbers(cell, seed: int, device) -> dict:
    from anns_bench import judge
    from anns_bench.cell import load
    from anns_bench.data import generate
    from anns_bench.reference import Reference

    cfg = cell.config
    route = load("routes", cell.traffic["route"])
    data = generate(cfg["dataset"], seed, device)
    ref = Reference(data["base"], device)
    qidx = route.answered(cell.traffic, len(data["query"]))
    ids, d = route.control(ref, data["query"][qidx], cfg)
    numbers, _ = route.judge(ref, data["query"], qidx, ids, d, 0,
                             int(cfg["protocol"]["k"]))
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
