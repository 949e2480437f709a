"""Median over the window's /search requests of the program's own
``launch`` span (engine/server.py search_fused_async): the host's enqueue of
the scan, the selection, the id resolution, the re-rank and the final
top-k."""

from anns_bench import program_spans


def read(run):
    return program_spans.median(run, "POST /search", lambda r: r.ms("launch"))
