"""Median over the window's /pir-fetch requests, over those whose span lies
wholly inside the profiled slice, of the device time of the kernels
launched inside DevicePIR2's "expansion (K2 + elementwise)" stage: the
oblivious expansion's key switches (K2 and int64 elementwise work) and the
selectors' forward transforms."""

from anns_bench import span_device
from anns_bench.stats import median


def read(run):
    v = [ms for _, ms in span_device.span_ms(run,
                                             "expansion (K2 + elementwise)")]
    return median(v) if v else None
