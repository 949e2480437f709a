"""The search route sends the same batches for every seed, each once a
cycle, in an order drawn from the seed; its warm-up sends each batch."""

import numpy as np
import torch

from anns_bench import tracing
from anns_bench.data import make_sift_style
from anns_bench.sut import System
from anns_bench.tests.small import small_cell
from anns_bench.traffic import Traffic


def test_search_batches_are_fixed_and_the_seed_orders_them():
    cell = small_cell("sift1m-ivfpq-triage.search-b64")
    cfg, mix = cell.config, cell.traffic
    dev = torch.device("cpu")
    seeds = (2**31 + 5, 2**31 + 6)
    data = [make_sift_style(cfg["dataset"], s, dev) for s in seeds]
    assert np.array_equal(data[0]["query"], data[1]["query"])
    system = System(cfg, data[0], dev, int(mix["rows_per_request"]))
    try:
        ts = [Traffic(mix, cfg, system, d["query"], s, tracing.Tracer(False))
              for s, d in zip(seeds, data)]
        for t in ts:
            t.prepare()
        nb = len(ts[0].bodies)
        assert ts[0].bodies == ts[1].bodies
        for t in ts:
            assert sorted(t._items(0)) == list(range(nb))
        assert ts[0]._items(0) != ts[1]._items(0)
        sent = []
        ts[0]._send_search = lambda c, b: (sent.append(b), (True, b""))[1]
        ts[0].mix = dict(mix, warm_requests=nb)
        ts[0].warm()
        assert sorted(sent) == list(range(nb))
    finally:
        system.close()
