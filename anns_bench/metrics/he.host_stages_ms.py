"""Median over the window's /encryptedsearch requests of the program's
``encrypted search`` span minus its ``device program`` stage: the engine's
host stages around the HE device program."""

from anns_bench import program_spans


def _host(r):
    return next((r.self_ms(s, "device program")
                 for s in r.named("encrypted search")), None)


def read(run):
    return program_spans.median(run, "POST /encryptedsearch", _host)
