"""Median over two-round requests of the Dispatcher's own time: the spans
around handle of /coarsesearch and /encryptedsearch minus the spans around
the engine's coarse_search_topk and encrypted_precise_search inside them
(JSON parse and dumps included)."""

from anns_bench.stats import median

KEYS = ("handle:/coarsesearch", "engine.coarse_search_topk",
        "handle:/encryptedsearch", "engine.encrypted_precise_search")


def read(run):
    v = [(s[KEYS[0]] - s[KEYS[1]]) + (s[KEYS[2]] - s[KEYS[3]])
         for s in (r.spans for r in run.reqs)
         if s and all(k in s for k in KEYS)]
    return median(v) if v else None
