"""The PIR section (bench.py ``run_pir`` :987-1135): single-server private
row retrieval at the dataset's full size through ``DevicePIR2``.

By default the production stage-8 form only: the multi-row packed wire, one
uploaded ciphertext a ⌊N/m⌋ rows, 100 rows as ⌈100/k⌉ ciphertexts answered
by one program. ``PFH_BENCH_PIR_FULL=1`` adds the single-row form (3 rows
timed after a warm one) and 100 single-row ciphertexts in one batched
request. Every fetched row must equal its base row.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from prefhetch_tpu_torch.bench.core import CheckFailed
from prefhetch_tpu_torch.bench.data import D, BenchConfig


def _check_rows(client, resps, rads, rows, base) -> None:
    for resp, rad, row in zip(resps, rads, rows):
        got = client.decode_response_2d(resp, D, rad)
        if not np.array_equal(got, np.round(base[row]).astype(np.int64)):
            raise CheckFailed(f"PIR row {row} came back wrong")


def run_pir(cfg: BenchConfig, data, device) -> dict:
    from prefhetch_tpu_torch.crypto.params import pir_params_for
    from prefhetch_tpu_torch.crypto.pir import PIRClient
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

    p = pir_params_for(4096, 257, 2)
    client = PIRClient(p, seed=17)
    base = data["base"]
    nbase = len(base)
    tp = time.perf_counter()

    def phase(tag):
        nonlocal tp
        now = time.perf_counter()
        print(f"[bench] pir phase {tag}: {now - tp:.1f}s", file=sys.stderr)
        tp = now

    server = DevicePIR2(base, p, device=device)
    phase("server init (pack, upload, database transform)")
    k_ct = server.rows_per_ct()
    gw = (client.galois_keys_wire_2d_multi(nbase, D, k_ct) if k_ct > 1
          else client.galois_keys_wire_2d(nbase, D))
    phase("galois keys (client)")
    server.register_galois_keys(client.key_id, gw)
    phase("register keys")
    mrows = np.random.default_rng(29).integers(0, nbase, 100).tolist()
    wires, rads = [], []
    for i in range(0, len(mrows), k_ct):
        ch = mrows[i: i + k_ct]
        nv = len(ch)
        w, rs = client.build_query_2d_multi(ch + [ch[-1]] * (k_ct - nv),
                                            nbase, D)
        wires.append(w)
        rads.extend(rs[:nv])
    phase("client query build")
    resps = server.answer_2d_multi_batch(wires, client.key_id, k_ct)  # warm
    phase("warm answer pass")
    t0 = time.perf_counter()
    resps = server.answer_2d_multi_batch(wires, client.key_id, k_ct)
    mms = (time.perf_counter() - t0) / len(mrows) * 1e3
    phase("timed answer pass")
    # every chunk carries k_ct responses; the padded tail's are dropped
    kept = [resps[c * k_ct + j] for c in range(len(wires))
            for j in range(min(k_ct, len(mrows) - c * k_ct))]
    _check_rows(client, kept, rads, mrows, base)
    phase("client decode and check of 100 rows")
    res = {
        "pir_nbase": nbase,
        "pir_multi100_ms_per_row": mms,
        "pir_rows_per_ct": k_ct,
        "pir_multi_upload_bytes_per_row": int(
            len(json.dumps(wires)) / len(mrows)),
    }
    if not cfg.pir_full:
        return res

    # the multi-row key stack is a superset of the single-row tree
    def fetch(rows):
        built = [client.build_query_2d(r, nbase, D) for r in rows]
        out = [server.answer_2d(w, client.key_id) for w, _ in built]
        _check_rows(client, out, [r for _, r in built], rows, base)

    fetch([123_457 % nbase])                      # warm
    rows = [5, nbase - 2, (7 * nbase) // 11]
    t0 = time.perf_counter()
    fetch(rows)
    res["pir_fetch_ms_per_row"] = (time.perf_counter() - t0) / len(rows) * 1e3

    # K=100 rows as 100 single-row cts in ONE batched request
    brows = np.random.default_rng(23).integers(0, nbase, 100).tolist()
    built = [client.build_query_2d(r, nbase, D) for r in brows]
    bwires = [w for w, _ in built]
    server.answer_2d_batch(bwires, client.key_id)        # warm
    t0 = time.perf_counter()
    bresps = server.answer_2d_batch(bwires, client.key_id)
    res["pir_batch100_ms_per_row"] = (
        (time.perf_counter() - t0) / len(brows) * 1e3)
    _check_rows(client, bresps, [r for _, r in built], brows, base)
    return res
