"""The PIR fetch's deployment (configs/sift1m-pir.json, workloads/
fetch-100.json, routes/pir_fetch.py, client/pir_hypercube.py) and its six
readers: the client copy's wires and decoding equal the program's client's
for one seed; a run at a small size on the CPU is correct, and a row
swapped, a response ciphertext dropped or a value of 256 is not; the
control is not correct; the readers on a hand-made slice, and nothing read
where there is nothing to read; the byte functions against hand counts."""

import collections
import json
import types

import numpy as np
import pytest
import torch

from anns_bench import control, pir_work, program_spans, roofline, run
from anns_bench import span_device
from anns_bench.cell import load, load_cell, load_reader
from anns_bench.client.pir_hypercube import Client, grid_dims
from anns_bench.routes import pir_fetch
from anns_bench.run import FORBIDDEN
from anns_bench.tests.small import small_cell
from anns_bench.tests.test_anns_imports import _top_level_after
from anns_bench.traffic import Traffic
from prefhetch_tpu_torch.crypto.params import pir_params_for
from prefhetch_tpu_torch.crypto.pir import PIR2Server, PIRClient
from prefhetch_tpu_torch.engine.pir_device import DevicePIR2
from prefhetch_tpu_torch.engine.server import QueryEngine

CELL = "sift1m-pir.fetch-100"
READERS = ("pir.expand_ms", "pir.fold1_ms", "pir.fold1.roofline_pct",
           "ntt.roofline_pct.pir", "wire.self_ms.pir.program",
           "device.idle_pct.pir")


def test_the_cells_names_load():
    cell = load_cell(CELL)
    route = load("routes", cell.traffic["route"])
    assert route is pir_fetch and issubclass(route.Route, Traffic)
    assert callable(route.judge) and callable(route.control)
    assert callable(load("entries", cell.traffic["entry"]).Entry)
    assert callable(load("generators",
                         cell.config["dataset"]["generator"]).generate)
    assert {m.name for m in cell.per_layer} == set(READERS)
    assert {m.name for m in cell.end_to_end} == {
        "qps", "recall_at_100", "peak_mem_gb", "setup_s"}
    # the triage's corpus and index, so the index cache is shared
    tri = load_cell("sift1m-ivfpq-triage.search-b64").config
    for key in ("dataset", "index", "protocol"):
        assert cell.config[key] == tri[key]


def test_the_deployment_at_its_size():
    """100 rows a query in 10 ciphertexts of 11, expanded to depth 12 (one
    program of MAX_EXPANDED), a 177 x 177 hypercube."""
    cfg = load_cell(CELL).config
    assert pir_fetch.rows_per_ct(cfg) == 11
    parts = pir_fetch.chunks(np.arange(100), 11)
    assert len(parts) == 10 and [v for _, v in parts] == [11] * 9 + [1]
    assert parts[-1][0] == [99] * 11
    assert grid_dims(4096, 1_000_000, 128) == (31_250, 177, 177)
    assert ((11 * 354 - 1).bit_length(), 10 << 12) == (12, 40_960)


# -- the client copy against the program's client ------------------------------

N, NB, D = 256, 256, 32           # R = 8, G = 32, g1 = g2 = 6, m = 12


def test_client_copy_wires_and_decoding_equal_the_programs():
    params = pir_params_for(N, 257, 2)
    mine = Client(N, 257, 2, seed=11, key_id="k")
    theirs = PIRClient(params, seed=11)
    keys = mine.galois_keys_wire(NB, D, 3)
    assert keys == theirs.galois_keys_wire_2d_multi(NB, D, 3)
    rows = [5, 100, 255]
    (w, rs), (w1, rs1) = mine.query_wires([rows, [7, 7]], NB, D)
    w2, rs2 = theirs.build_query_2d_multi(rows, NB, D)
    assert w == w2 and rs == rs2
    assert (w1, rs1) == theirs.build_query_2d_multi([7, 7], NB, D)
    base = np.random.default_rng(3).integers(0, 256, (NB, D))
    srv = PIR2Server(base.astype(np.float32), params)
    srv.register_galois_keys("k", keys)
    resps = srv.answer_2d_multi(w2, "k", 3)
    got = mine.decode(resps, D, rs)
    want = np.stack([theirs.decode_response_2d(r, D, rs2[i])
                     for i, r in enumerate(resps)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base[rows])


def test_client_route_and_work_load_nothing_of_the_program():
    names = _top_level_after(
        "import anns_bench.client.pir_hypercube, anns_bench.routes.pir_fetch\n"
        "import anns_bench.pir_work\n")
    assert not names & ({"prefhetch_tpu_torch"} | set(FORBIDDEN))


def test_client_decode_refuses_a_short_response():
    mine = Client(N, 257, 2, seed=11, key_id="k")
    resp = {"cts": [], "nDigits": 2, "g1": 6, "g2": 6, "logF": 6}
    with pytest.raises(ValueError):
        mine.decode([resp], D, [0])
    with pytest.raises(ValueError):
        mine.decode([], D, [0])


# -- runs on the CPU -------------------------------------------------------------

def _small():
    cell = small_cell(CELL)
    cell.config["protocol"]["k"] = 4       # 4 rows a ciphertext: depth 7
    cell.traffic["queries_per_client"] = 2
    return cell


def _run():
    return run.execute(_small(), 2**31 + 77, 0.5, False, device="cpu")


def test_sound_pir_run_is_correct():
    out = _run()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["warm_failed"] == 0
    assert out["correct"], out["checks"]


def _swap_rows(orig):
    def fetch(self, *a, **kw):
        out = orig(self, *a, **kw)
        out[0], out[1] = out[1], out[0]
        return out
    return fetch


def _drop_ct(orig):
    def fetch(self, *a, **kw):
        out = orig(self, *a, **kw)
        out[0] = dict(out[0], cts=out[0]["cts"][:-1])
        return out
    return fetch


def _value_256(orig):
    def init(self, base, *a, **kw):
        base = np.array(base)
        base[:, 0] = 256                  # below t = 257: it packs
        orig(self, base, *a, **kw)
    return init


@pytest.mark.parametrize("fault,owner,attr,number", [
    (_swap_rows, QueryEngine, "pir_fetch", "dist_gap"),
    (_drop_ct, QueryEngine, "pir_fetch", "failed"),
    (_value_256, DevicePIR2, "__init__", "failed"),
])
def test_broken_pir_path_is_not_correct(monkeypatch, fault, owner, attr,
                                        number):
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    out = _run()
    assert out["attempted"] > 0
    assert not out["correct"]
    assert out["checks"][number]["value"] >= 1, out["checks"]


def test_control_is_not_correct():
    got = control.control_numbers(_small(), 2**31 + 77, torch.device("cpu"))
    assert not got["correct"]
    c = got["checks"]
    assert c["dist_gap"]["value"] > 0
    assert c["order_gap"]["value"] == 0 and c["failed"]["value"] == 0
    assert c["recall_at_100"]["value"] == 1.0


# -- the readers on a hand-made slice ----------------------------------------------

Span = collections.namedtuple("Span",
                              "name request id parent tid ident t0 t1")
Counter = collections.namedtuple("Counter", "name request span n")
MONO0, REAL0 = 10**9, 1_700_000_000 * 10**9
BASE = REAL0 - MONO0 - 5 * 10**6       # trace µs = stamp ns / 1000 + 5000
TID = 11
IDENT = (0x7F12 << 32) | TID
ROUTE = "POST /pir-fetch"
K2 = "void (anonymous namespace)::ntt4_kernel<64, false>(int const*)"


def _ns(us):
    return int((us - 5000) * 1000)


def _request(rid, engine=True):
    """One /pir-fetch request, 1000-20000 µs: json parse, the engine span
    2000-18000 with DevicePIR2's stages, json.dumps."""
    kids = [("json parse", 0, 1000, 2000), ("engine", 0, 2000, 18000),
            ("wire decode", 2, 2000, 2500), ("upload", 2, 2500, 3000),
            ("expansion (K2 + elementwise)", 2, 3000, 8000),
            ("dim-1 fold", 2, 8000, 14000), ("dim-2 fold", 2, 14000, 16000),
            ("download", 2, 16000, 16500), ("pack_i32", 2, 16500, 18000),
            ("json.dumps", 0, 18000, 19500)]
    out = [Span(ROUTE, rid, rid, 0, 4242, IDENT, _ns(1000), _ns(20000))]
    for i, (name, parent, a, b) in enumerate(kids, start=1):
        if not engine and name == "engine":
            name = "register"             # a program without the span
        out.append(Span(name, rid, rid + i, rid + parent, 4242, IDENT,
                        _ns(a), _ns(b)))
    return out


def _event(cat, ts, dur, corr, name=None):
    return {"ph": "X", "cat": cat, "name": name or cat, "ts": ts, "dur": dur,
            "tid": TID, "args": {"correlation": corr}}


# (call µs, kernel µs, name): three in the expansion (two K2), two in the
# dim-1 fold, one K2 in the dim-2 fold
LAUNCHES = [(3100, 1000, K2), (4500, 500, "elementwise"), (5500, 2000, K2),
            (8100, 3000, "addcmul"), (12000, 1000, "remainder"),
            (14100, 400, K2)]
COUNTS = {"pir.cts": 10, "pir.rows": 110, "pir.programs": 1,
          "pir.expanded": 40_960, "pir.selector_sets": 110,
          "k2.rows.i32": 1_000, "k2.rows.i64": 500}


@pytest.fixture
def run_of(tmp_path, monkeypatch):
    monkeypatch.setattr(program_spans, "SCRATCH", str(tmp_path))
    monkeypatch.setattr(span_device, "SCRATCH", str(tmp_path))

    def make(device=True, buffer=True, counters=True, engine=True,
             spans=True, lost=False):
        sp = _request(1, engine) if spans else []
        buf = {"spans": sp, "dropped": 0, "clock": (MONO0, REAL0)}
        monkeypatch.setattr(program_spans, "_fetch",
                            lambda: buf if buffer else None)
        cs = [Counter(k, 1, 2, v) for k, v in COUNTS.items()]
        monkeypatch.setattr(span_device, "_counters",
                            lambda: cs if counters else [])
        ev = [_event("cuda_runtime", 500, 5, 100),
              _event("kernel", 600, 100, 100)]
        for i, (t, dur, name) in enumerate(LAUNCHES):
            if not lost:              # the profiler kept the kernels
                ev += [_event("cuda_runtime", t, 5, i + 1),
                       _event("kernel", t + 50, dur, i + 1, name)]
        ev += [_event("cuda_runtime", 20500, 5, 99),
               _event("kernel", 20600, 100, 99)]
        with open(tmp_path / "slice_trace.json", "w") as f:
            json.dump({"baseTimeNanoseconds": BASE, "traceEvents": ev}, f)
        busy = 100 + sum(d for _, d, _ in LAUNCHES) + 100
        dev = {"busy_s": busy * 1e-6, "window_s": 20200 * 1e-6}
        return types.SimpleNamespace(
            reqs=[types.SimpleNamespace(t_send=_ns(1000) / 1e9)],
            deadline=_ns(20000) / 1e9 + 1, device=dev if device else None)

    return make


def _read(name, run):
    return load_reader(name)(run)


def test_pir_readers_on_a_known_slice(run_of, tmp_path):
    run = run_of()
    assert _read("pir.expand_ms", run) == pytest.approx(3.5)
    assert _read("pir.fold1_ms", run) == pytest.approx(4.0)
    fold = pir_work.fold1_bytes(1, 110, 177, 177, 2, 4096)
    assert _read("pir.fold1.roofline_pct", run) == pytest.approx(
        100 * fold / roofline.HBM_BYTES_S / 4e-3)
    k2 = pir_work.k2_bytes(1_000, 500, 3, 4096)
    assert _read("ntt.roofline_pct.pir", run) == pytest.approx(
        100 * k2 / roofline.HBM_BYTES_S / 3.4e-3)
    assert _read("wire.self_ms.pir.program", run) == pytest.approx(3.0)
    assert _read("device.idle_pct.pir", run) == pytest.approx(
        100 * (1 - 8100 / 20200))
    with open(tmp_path / f"idle_by_span.{CELL}.json") as f:
        by = json.load(f)["idle_ms_by_span"]
    # idle inside the stages: the expansion's 5 ms less its 3.5 ms busy
    assert by[f"{ROUTE} > engine > expansion (K2 + elementwise)"] \
        == pytest.approx(1.5)
    assert by[f"{ROUTE} > json.dumps"] == pytest.approx(1.5)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no recorder", "no spans", "no slice",
                                  "no counters", "no engine span",
                                  "records lost"])
def test_pir_readers_read_nothing_where_nothing_is_there(run_of, name, case):
    kw = {"no recorder": {"buffer": False}, "no spans": {"spans": False},
          "no slice": {"device": False}, "no counters": {"counters": False},
          "no engine span": {"engine": False},
          "records lost": {"lost": True}}[case]
    got = _read(name, run_of(**kw))
    # what each case leaves readable: the idle share needs only the slice,
    # the program's own span only the spans, the stages' device times the
    # spans and the slice, the rooflines the counters too
    # a slice that kept the copies and lost every kernel (seen once in 7
    # traced runs on the H100) reads nothing from the device
    readable = {
        "device.idle_pct.pir": case not in ("no slice", "records lost"),
        "wire.self_ms.pir.program": case in ("no slice", "no counters",
                                             "records lost"),
        "pir.expand_ms": case in ("no counters", "no engine span"),
        "pir.fold1_ms": case in ("no counters", "no engine span"),
        "pir.fold1.roofline_pct": case == "no engine span",
        "ntt.roofline_pct.pir": case == "no engine span",
    }[name]
    if readable:
        assert got is not None and got > 0
    else:
        assert got is None


def test_a_span_partly_outside_the_slice_is_not_read(run_of, tmp_path):
    run = run_of()
    path = tmp_path / "slice_trace.json"
    with open(path) as f:
        trace = json.load(f)
    # the slice now begins at 7900 µs: the expansion and the root lie
    # partly outside it, the dim-1 fold inside
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["ts"] >= 8000] + [
        _event("kernel", 7900, 10, 200)]
    with open(path, "w") as f:
        json.dump(trace, f)
    assert _read("pir.expand_ms", run) is None
    assert _read("ntt.roofline_pct.pir", run) is None
    assert _read("pir.fold1_ms", run) == pytest.approx(4.0)


# -- the byte functions ------------------------------------------------------------

def test_fold1_bytes_against_a_hand_count():
    # the SIFT1M database once: 177 x 177 blocks of 2 limbs x 4,096 int32
    db = 177 * 177 * 2 * 4096 * 4
    assert db == 1_026_588_672
    # a selector set: 177 selector cts in, 177 column sums out, both int32
    per_set = 177 * 2 * 2 * 4096 * 4 + 2 * 177 * 2 * 4096 * 4
    assert per_set == 23_199_744
    assert pir_work.fold1_bytes(1, 110, 177, 177, 2, 4096) \
        == db + 110 * per_set == 3_578_560_512
    assert pir_work.fold1_bytes(2, 3, 8, 8, 2, 4096) \
        == 2 * 8 * 8 * 32768 + 3 * (16 + 16) * 32768


def test_k2_bytes_against_a_hand_count_and_ntt_work():
    # [163,840, 4,096] int32 forward and [81,920] int64 inverse, 64 x 64
    tables = 4 * (64 * 64 * 3)
    assert pir_work.k2_bytes(163_840, 81_920, 2, 4096) == (
        163_840 * 4096 * 8 + 81_920 * 4096 * 12 + 2 * tables)
    assert pir_work.k2_bytes(163_840, 81_920, 2, 4096) == (
        roofline.ntt_work(163_840, 4096, 4, 64, 64)
        + roofline.ntt_work(81_920, 4096, 8, 64, 64))
    assert pir_work.ntt_tables(4096) == (64, 64)
    assert pir_work.ntt_tables(8192) == (64, 128)
