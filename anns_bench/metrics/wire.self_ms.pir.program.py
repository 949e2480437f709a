"""Median over the window's /pir-fetch requests of the program's root span
(Dispatcher.handle) minus its ``engine`` child (QueryEngine.pir_fetch):
the JSON parse of the query ciphertexts, the ``json.dumps`` of the
response, checks and routing."""

from anns_bench import program_spans


def read(run):
    return program_spans.median(run, "POST /pir-fetch",
                                lambda r: r.self_ms(r.root, "engine"))
