"""Median over the window's /search requests of the program's root span
(Dispatcher.handle) minus its ``engine`` child: decode, checks, encode and
routing; the inside twin of wire.self_ms.triage."""

from anns_bench import program_spans


def read(run):
    return program_spans.median(run, "POST /search",
                                lambda r: r.self_ms(r.root, "engine"))
