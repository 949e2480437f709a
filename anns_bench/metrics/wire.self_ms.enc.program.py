"""Median over two-round requests of the Dispatcher's own time from the
program's root spans: the /coarsesearch root minus its ``engine`` child
plus the /encryptedsearch root that follows it on the same thread minus its
``encrypted search`` child; the inside twin of wire.self_ms.enc."""

from anns_bench import program_spans
from anns_bench.stats import median


def read(run):
    v = []
    for c, e in program_spans.pairs(run, "POST /coarsesearch",
                                    "POST /encryptedsearch"):
        a = c.self_ms(c.root, "engine")
        b = e.self_ms(e.root, "encrypted search")
        if a is not None and b is not None:
            v.append(a + b)
    return median(v) if v else None
