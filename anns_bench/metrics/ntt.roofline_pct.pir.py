"""K2's share of its byte bound at the PIR fetch's shapes: pir_work.k2_bytes
(each launch's rows read and written once, as roofline.ntt_work counts,
from the request's ``k2.rows.i32`` and ``k2.rows.i64`` counters, and the
tables once a launch) at the peak bandwidth, over the device time of the
K2 kernels (``ntt4_kernel``) launched inside the request, summed over the
/pir-fetch requests wholly inside the profiled slice."""

import json
import os

from anns_bench import pir_work, roofline, span_device
from anns_bench.cell import HERE

CONFIG = os.path.join(HERE, "configs", "sift1m-pir.json")
KERNEL = "ntt4_kernel"


def read(run):
    with open(CONFIG) as f:
        n = int(json.load(f)["he"]["n"])
    nbytes = dev_ms = 0.0
    for r in span_device.requests(run):
        c = span_device.counters(run, r)
        got = span_device.kernel_ms(run, r, KERNEL)
        if got is None or not got[1] or not any(k.startswith("k2.rows.")
                                                for k in c):
            continue
        nbytes += pir_work.k2_bytes(c.get("k2.rows.i32", 0),
                                    c.get("k2.rows.i64", 0), got[1], n)
        dev_ms += got[0]
    if dev_ms <= 0:
        return None
    return 100.0 * roofline.bound_s(nbytes)[0] / (dev_ms / 1e3)
