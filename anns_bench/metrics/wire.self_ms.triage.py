"""Median over requests of the harness's span around Dispatcher.handle of
/search minus its span around the engine's search_fused inside it."""

from anns_bench.stats import median


def read(run):
    v = [s["handle:/search"] - s["engine.search_fused"]
         for s in (r.spans for r in run.reqs)
         if s and "handle:/search" in s and "engine.search_fused" in s]
    return median(v) if v else None
