"""Client worker of the encrypted HTTP bench (bench.py
``_HTTP_ENC_WORKER_SRC`` :1810-1884), run in its own process:

    python -m prefhetch_tpu_torch.bench.enc_worker ADDR DIR N_WORKERS N_ITER

DIR holds queries.npy, cand.npy and ref.npy (the plaintext distances). Each
of N_WORKERS threads owns an HEClient (its own keys and key id), registers
its Galois keys with its first request, and posts N_ITER 64-query batches
of seedTf queries to POST /encryptedsearch on the packed wire, decrypting
each. Prints "<t_start> <t_end> <max_err> <lat0> <lat1> ...": the window
after every worker's first batch, the largest |distance error| of the
first batches, and each timed batch's latency in seconds.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np


# the server is local: no proxy, whatever the environment names
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def post(addr: str, payload: dict) -> dict:
    req = urllib.request.Request(
        addr + "encryptedsearch", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with _OPENER.open(req, timeout=600) as r:
        return json.loads(r.read())


def main(argv) -> int:
    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.utils.config import HEParams

    addr, td, n_workers, n_iter = argv[0], argv[1], int(argv[2]), int(argv[3])
    queries = np.load(os.path.join(td, "queries.npy"))
    cand = np.load(os.path.join(td, "cand.npy"))
    ref = np.load(os.path.join(td, "ref.npy"))
    d = queries.shape[1]
    lats, errs, failures = [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(n_workers + 1)

    def worker(wi):
        try:
            hc = HEClient(HEParams(resp_mod="packed"), seed=11 + wi)
            base = {"nearestCoarseVectorIndexes": cand.tolist(),
                    "scheme": "bfv", "keyId": hc.key_id, "respMod": "packed"}

            def round_trip(first: bool):
                p = dict(base)
                if first:
                    p["galoisKeys"] = hc.bfv_extraction_keys_wire(d)
                p["encryptedPreciseQuery"] = hc.encrypt_query_batch(queries)
                r = post(addr, p)
                return hc.decrypt_scores_packed(
                    r["packedScores"], np.asarray(r["candidateNorms"]),
                    queries, r["packGroup"])

            out = round_trip(True)     # registers the keys, warms, checks
            with lock:
                errs.append(float(np.abs(out - ref).max()))
        except BaseException as e:     # report it once the barrier breaks
            failures.append(repr(e))
            barrier.abort()
            raise
        barrier.wait()
        for _ in range(n_iter):
            t0 = time.perf_counter()
            round_trip(False)
            with lock:
                lats.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    try:
        barrier.wait()                 # every worker warmed and checked
    except threading.BrokenBarrierError:
        for t in threads:
            t.join()
        print(f"worker failed: {failures}", file=sys.stderr)
        return 1
    t_start = time.time()
    for t in threads:
        t.join()
    t_end = time.time()
    if len(lats) != n_workers * n_iter:
        print(f"{n_workers * n_iter - len(lats)} batches failed",
              file=sys.stderr)
        return 1
    print(f"{t_start:.6f} {t_end:.6f} {max(errs):.6f} "
          + " ".join(f"{x:.6f}" for x in lats))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
