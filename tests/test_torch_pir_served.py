"""The PIR fetch on the served path (CPU): ``POST /pir-fetch`` in its
``pirHypercubeMulti`` form through ``Dispatcher.handle`` at the served ring
(N=4096, 2 limbs, t=257, d=128) over 2,048 byte-valued rows, an 8 x 8
hypercube; decrypted, every fetched row equals the base row byte for byte.
Under ``record_stages()`` a request is one span tree, root > ``engine`` >
``DevicePIR2``'s seven stages, and its counters (``pir.*``, ``k2.rows.*``)
are what the request implies; outside it, nothing is counted, at the cost
of one thread-local check.

This file imports only torch and the port. A ciphertext here carries a few
rows (the expansion tree's depth, and the CPU's time, grow with them);
``rows_per_ct`` would pack 256."""

import json

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.crypto.params import pir_params_for
from prefhetch_tpu_torch.crypto.pir import PIRClient
from prefhetch_tpu_torch.engine.server import QueryEngine
from prefhetch_tpu_torch.index.build import build_ivf_index
from prefhetch_tpu_torch.serve.handlers import Dispatcher
from prefhetch_tpu_torch.utils import stages
from prefhetch_tpu_torch.utils.config import (
    HEParams, IndexParams, PipelineConfig, ProtocolParams,
)

torch.set_num_threads(1)

NBASE, D, N = 2048, 128, 4096      # R = 32 rows a block, G = 64, g1 = g2 = 8
JSON = {"content-type": "application/json"}
STAGES = ["wire decode", "upload", "expansion (K2 + elementwise)",
          "dim-1 fold", "dim-2 fold", "download", "pack_i32"]


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(31)
    base = rng.integers(0, 256, (NBASE, D)).astype(np.float32)
    cfg = PipelineConfig(
        index=IndexParams(d=D, nlist=8, pq_m=8, pq_nbits=8,
                          kmeans_iters=3, pq_kmeans_iters=3),
        protocol=ProtocolParams(nprobe=2, coarse_probe=16, k=8, nquery=1,
                                pir_mode="he"),
        he=HEParams(n=N, n_limbs=2, pir_plain_modulus=257),
        nbase=NBASE,
    )
    eng = QueryEngine(cfg, device="cpu")
    eng.set_index(build_ivf_index(base[:1024], base, cfg.index,
                                  device="cpu"), base)
    client = PIRClient(pir_params_for(N, 257, 2), seed=5)
    return Dispatcher(eng), base, client


def _request(client, ids, n_rows, keys):
    """A pirHypercubeMulti body for ``ids``: chunks of n_rows, the last
    padded by repeating its final row (client/pipeline.py's convention)."""
    entries, rs = [], []
    for i in range(0, len(ids), n_rows):
        chunk = list(ids[i:i + n_rows])
        valid = len(chunk)
        chunk += [chunk[-1]] * (n_rows - valid)
        w, r = client.build_query_2d_multi(chunk, NBASE, D)
        entries.append({"ct": w, "nRows": n_rows})
        rs.append((valid, r))
    body = {"pirHypercubeMulti": entries, "keyId": client.key_id}
    if keys:
        body["galoisKeys"] = client.galois_keys_wire_2d_multi(NBASE, D,
                                                              n_rows)
    return json.dumps(body).encode(), rs


def _fetch(disp, client, ids, n_rows, keys=True):
    body, rs = _request(client, ids, n_rows, keys)
    st, _, resp = disp.handle("POST", "/pir-fetch", JSON, body)
    assert st == 200, resp[:200]
    results = json.loads(resp)["pirResults"]
    assert len(results) == len(rs) * n_rows
    rows = []
    for c, (valid, r) in enumerate(rs):
        for j in range(valid):
            rows.append(client.decode_response_2d(results[c * n_rows + j],
                                                  D, r[j]))
    return np.stack(rows)


# one full ciphertext, a padded last ciphertext, two ciphertexts
CASES = {"one-full": ([7, 40, 1999, 1024], 4),
         "padded-last": ([2047, 3, 600], 4),
         "two-cts": ([0, 31, 32, 33, 1500, 1501, 900, 64], 4)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pir_fetch_rows_equal_the_base_byte_for_byte(served, case):
    disp, base, client = served
    ids, n_rows = CASES[case]
    got = _fetch(disp, client, ids, n_rows)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.astype(np.uint8),
                                  base[ids].astype(np.uint8))
    np.testing.assert_array_equal(got, base[ids])


def test_a_recorded_fetch_is_one_span_tree_with_its_counters(served):
    disp, base, client = served
    ids, n_rows = CASES["two-cts"]
    _fetch(disp, client, ids, n_rows)               # keys registered
    stages.clear_spans()
    with stages.record_stages():
        got = _fetch(disp, client, ids, n_rows, keys=False)
    np.testing.assert_array_equal(got, base[ids])
    rec = stages.recorded_spans()
    spans = rec["spans"]
    (root,) = [s for s in spans if s.parent == 0]
    assert root.name == "POST /pir-fetch"
    kids = sorted((s for s in spans if s.parent == root.id),
                  key=lambda s: s.t0)
    assert [s.name for s in kids] == ["json parse", "engine", "json.dumps"]
    engine = kids[1]
    inner = sorted((s for s in spans if s.parent == engine.id),
                   key=lambda s: s.t0)
    assert [s.name for s in inner] == STAGES
    assert all(s.request == root.id for s in spans)

    by = {}
    for c in rec["counters"]:
        assert c.request == root.id
        by[c.name] = by.get(c.name, 0) + c.n
    B = 2                                     # cts
    svc = disp.engine.pir2_service
    m = svc.g1 + svc.g2
    logm = (n_rows * m - 1).bit_length()
    S = B * n_rows
    assert (svc.g1, svc.g2) == (8, 8)
    assert {k: v for k, v in by.items() if k.startswith("pir.")} == {
        "pir.cts": B, "pir.rows": B * n_rows, "pir.programs": 1,
        "pir.expanded": B << logm, "pir.selector_sets": S}
    # the rows of every K2 launch the program makes, by input dtype:
    # expansion's key switch over 3 extension primes a round (digits int32
    # forward, the two halves' int32 sums inverse, ops/key_switch.py), then
    # the selectors (int32), the dim-1 sums (int32, ops/pir_fold.py), the
    # digit planes (int64) and the dim-2 sums (int64), one launch a limb
    # each
    ks_rows = sum(B << (j + 1) for j in range(logm))
    nd = svc._n_digits
    L = 2
    assert by["k2.rows.i32"] == (3 * 4 * ks_rows + 3 * 2 * ks_rows
                                 + L * S * m * 2 + L * S * 2 * svc.g2)
    assert by["k2.rows.i64"] == (L * S * 2 * nd * svc.g2
                                 + L * S * 2 * nd * 2)
    # the program's counters sit on the engine span, K2's on the stages
    on = {c.span for c in rec["counters"] if c.name.startswith("pir.")}
    assert on == {engine.id}
    k2_on = {next(s.name for s in spans if s.id == c.span)
             for c in rec["counters"] if c.name.startswith("k2.")}
    assert k2_on == {"expansion (K2 + elementwise)", "dim-2 fold"}


def test_counters_record_nothing_while_recording_is_off(served):
    disp, base, client = served
    stages.clear_spans()
    ids, n_rows = CASES["padded-last"]
    np.testing.assert_array_equal(_fetch(disp, client, ids, n_rows),
                                  base[ids])
    stages.count("pir.cts", 3)
    rec = stages.recorded_spans()
    assert rec["spans"] == [] and rec["counters"] == []


def test_a_counter_with_no_open_span_counts_nothing():
    stages.clear_spans()
    with stages.record_stages():
        stages.count("k2.rows.i32", 5)
        with stages.span("a"):
            stages.count("k2.rows.i32", 2)
            stages.count("k2.rows.i32", 3)
            with stages.span("b"):
                stages.count("pir.cts", 1)
    rec = stages.recorded_spans()
    spans = {s.id: s.name for s in rec["spans"]}
    got = sorted((spans[c.span], c.name, c.n) for c in rec["counters"])
    assert got == [("a", "k2.rows.i32", 5), ("b", "pir.cts", 1)]


class _Probe:
    """A stand-in for the recorder's thread-local: counts attribute reads."""

    def __init__(self):
        self.reads = []

    def __getattr__(self, name):
        self.reads.append(name)
        return None


def test_off_a_counter_costs_the_one_check_a_span_costs(monkeypatch):
    probe = _Probe()
    monkeypatch.setattr(stages, "_local", probe)
    stages.span("engine")
    span_reads = list(probe.reads)
    probe.reads.clear()
    stages.count("pir.cts", 10)
    assert probe.reads == span_reads == ["times"]
