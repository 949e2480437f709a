"""The dim-1 fold's share of its byte bound: pir_work.fold1_bytes (the
database once a program, each selector set's selectors read and its sums
written once) at the peak bandwidth, over the device time of the kernels
launched inside the "dim-1 fold" stage; median over the /pir-fetch
requests whose stage lies wholly inside the profiled slice. The selector
sets and programs are the request's own counters (``pir.selector_sets``,
``pir.programs``); the hypercube's shape is the deployment's."""

import json
import os

from anns_bench import pir_work, roofline, span_device
from anns_bench.cell import HERE
from anns_bench.client.pir_hypercube import grid_dims
from anns_bench.stats import median

CONFIG = os.path.join(HERE, "configs", "sift1m-pir.json")


def read(run):
    with open(CONFIG) as f:
        cfg = json.load(f)
    n, L = int(cfg["he"]["n"]), int(cfg["he"]["n_limbs"])
    _, g1, g2 = grid_dims(n, int(cfg["dataset"]["nbase"]),
                          int(cfg["dataset"]["d"]))
    v = []
    for r, ms in span_device.span_ms(run, "dim-1 fold"):
        c = span_device.counters(run, r)
        if ms <= 0 or "pir.selector_sets" not in c:
            continue
        nbytes = pir_work.fold1_bytes(c["pir.programs"],
                                      c["pir.selector_sets"], g1, g2, L, n)
        v.append(100.0 * roofline.bound_s(nbytes)[0] / (ms / 1e3))
    return median(v) if v else None
