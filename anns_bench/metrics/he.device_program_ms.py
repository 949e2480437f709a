"""Median over requests of the program's own record_stages() "device
program" stage (engine/hecompute.py)."""

from anns_bench.stats import median


def read(run):
    v = [s["stage:device program"] for s in (r.spans for r in run.reqs)
         if s and "stage:device program" in s]
    return median(v) if v else None
