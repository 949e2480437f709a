"""Median over the window's /search requests of the program's own ``prep``
span (engine/server.py _tiled_batch_prep: probes → tiles → union →
upload); the inside twin of engine.prep_ms."""

from anns_bench import program_spans


def read(run):
    return program_spans.median(run, "POST /search", lambda r: r.ms("prep"))
