"""The device's idle share over the profiled slice while one of the
program's root spans (Dispatcher.handle) was open: device.idle_pct.enc
times the share of the slice's idle time inside a root span, so never
above it. Writes .scratch/idle_by_span.<cell>.json."""

from anns_bench import program_spans

CELL = "sift1m-bfv-packed.rerank-b64"


def read(run):
    return program_spans.idle_in_program_pct(run, CELL)
