"""The benchmark of the port: ``python -m prefhetch_tpu_torch.bench``.

The port of the JAX repo's ``bench.py``: one JSON line on stdout,
``{"metric": "ivfpq_query_pipeline_qps", "value", "unit", "vs_baseline",
"extra": {...}}``, with bench.py's key names, at its operating point
(SIFT-style 1M x 128, IVF1024 + PQ32x8, nprobe 16, COARSE_PROBE 256, K 100).
The headline is the triage pipeline's throughput (``core``); eight sections
follow in bench.py's order: encrypted (with the encrypted wire over HTTP),
http, ckks, pq, pir, angular and hard.

- ``data``      — the settings and their ``PFH_BENCH_*`` variables, the
                  three datasets and their indexes (cached under
                  ``bench_cache/torch/``), and the two numpy references:
                  ``numpy_pipeline`` (the baseline) and ``ivf_oracle_topk``
                  (the exact-IVF recall ceiling)
- ``core``      — the headline and the sections over ``query_pipeline``:
                  pq, angular and hard
- ``http``      — the closed-loop HTTP bench on the native frontend, its
                  clients in ``http_worker`` (another process)
- ``encrypted`` — the packed BFV re-rank, the encrypted wire over HTTP (its
                  clients in ``enc_worker``) and CKKS config 3
- ``pir``       — the multi-row private row retrieval of stage 8

Every figure is printed only with its answer checked (recall against exact
ground truth and the numpy pipeline, exact decryptions, exact PIR rows); a
section that fails or times out is named ``<name>_error`` in the line and
the process exits 1.
"""
