"""Median a call of the harness's span around QueryEngine._tiled_batch_prep
(probes → tiles → union → upload), wrapped at run time in the traced run."""

from anns_bench.stats import median


def read(run):
    v = run.tracer.calls.get("engine._tiled_batch_prep")
    return median(v) if v else None
