"""Median over the window's /pir-fetch requests, over those whose span lies
wholly inside the profiled slice, of the device time of the kernels
launched inside DevicePIR2's "dim-1 fold" stage: every selector set folded
against one pass over the packed database."""

from anns_bench import span_device
from anns_bench.stats import median


def read(run):
    v = [ms for _, ms in span_device.span_ms(run, "dim-1 fold")]
    return median(v) if v else None
