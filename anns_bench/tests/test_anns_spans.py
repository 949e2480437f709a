"""The readers of the program's own spans (program_spans.py and its nine
metrics) on a hand-made slice trace and span list with known idle intervals
and launches; and a run without the recorder, without spans or without a
slice, which reads nothing rather than 0."""

import collections
import json
import types

import pytest

from anns_bench import program_spans
from anns_bench.cell import load_reader

Span = collections.namedtuple("Span",
                              "name request id parent tid ident t0 t1")

MONO0, REAL0 = 10**9, 1_700_000_000 * 10**9
BASE = REAL0 - MONO0 - 5 * 10**6       # trace µs = stamp ns / 1000 + 5000
TID, OTHER = 11, 99
IDENT = (0x7F12 << 32) | TID      # the trace's tid: its low 32 bits

TRIAGE = ("engine.launch_ms.triage", "engine.launches.triage",
          "device.idle_in_program_pct.triage", "engine.prep_ms.program",
          "wire.self_ms.triage.program")
ENC = ("he.host_stages_ms", "he.program_launches",
       "device.idle_in_program_pct.enc", "wire.self_ms.enc.program")
FROM_SLICE = ("engine.launches.triage", "device.idle_in_program_pct.triage",
              "he.program_launches", "device.idle_in_program_pct.enc")


def _ns(us):
    """A program stamp (ns) that maps to trace µs ``us``."""
    return int((us - 5000) * 1000)


def _tree(rid, shift, route, kids):
    """Spans of one request from (name, parent index, start, end) in µs;
    index 0 is the root."""
    out = []
    for i, (name, parent, a, b) in enumerate([(route, None, *kids[0])]
                                             + kids[1:]):
        out.append(Span(name, rid, rid + i,
                        0 if parent is None else rid + parent, 4242,
                        IDENT, _ns(a + shift), _ns(b + shift)))
    return out


SEARCH = [(1000, 5000),
          ("wire decode", 0, 1000, 1100), ("engine", 0, 1100, 4800),
          ("prep", 2, 1100, 3000), ("launch", 2, 3000, 3500),
          ("resolve", 2, 3500, 4800), ("wire encode", 0, 4800, 4950)]


def _event(cat, ts, dur, corr, tid=TID):
    return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def _search_slice():
    """Two /search requests (7000 µs apart); device busy 900-950 and
    12500-12600 (launched from a thread without spans), 3100-3600 and
    10100-10400; enqueuing calls 3050, 3200, 3400 and 10050, 10200 inside
    the ``launch`` spans; a synchronise at 3600 enqueues nothing."""
    ev = [_event("cuda_runtime", 890, 5, 7, OTHER),
          _event("kernel", 900, 50, 7),
          _event("cuda_runtime", 3050, 5, 1), _event("kernel", 3100, 200, 1),
          _event("cuda_runtime", 3200, 5, 2), _event("kernel", 3300, 300, 2),
          _event("cuda_driver", 3400, 5, 3),
          _event("gpu_memcpy", 3450, 50, 3),
          _event("cuda_runtime", 3600, 5, 4),
          _event("cuda_runtime", 10050, 5, 5),
          _event("kernel", 10100, 200, 5),
          _event("cuda_runtime", 10200, 5, 6),
          _event("gpu_memset", 10300, 100, 6),
          _event("cuda_runtime", 12490, 5, 8, OTHER),
          _event("kernel", 12500, 100, 8)]
    spans = _tree(1, 0, "POST /search", SEARCH) \
        + _tree(10, 7000, "POST /search", SEARCH)
    return ev, spans


def _enc_slice():
    """One two-round request: /coarsesearch 1000-3000 (engine 1200-2800),
    /encryptedsearch 3000-11000 (json parse, encrypted search 4000-10000
    with its device program 6000-8000, json.dumps); four enqueuing calls
    inside the device program, one in the coarse round."""
    coarse = [(1000, 3000), ("engine", 0, 1200, 2800)]
    enc = [(3000, 11000), ("json parse", 0, 3000, 4000),
           ("encrypted search", 0, 4000, 10000),
           ("device program", 2, 6000, 8000),
           ("json.dumps", 0, 10000, 10900)]
    ev = [_event("cuda_runtime", 900, 5, 1), _event("kernel", 950, 40, 1),
          _event("cuda_runtime", 1500, 5, 2), _event("kernel", 1600, 400, 2)]
    for i, t in enumerate((6100, 6500, 7000, 7500)):
        ev += [_event("cuda_runtime", t, 5, 10 + i),
               _event("kernel", t + 20, 100, 10 + i)]
    ev += [_event("cuda_runtime", 11500, 5, 20, OTHER),
           _event("kernel", 11600, 50, 20)]
    return ev, (_tree(1, 0, "POST /coarsesearch", coarse)
                + _tree(10, 0, "POST /encryptedsearch", enc))


def _busy(ev):
    return [(e["ts"], e["ts"] + e["dur"]) for e in ev
            if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")]


@pytest.fixture
def run_of(tmp_path, monkeypatch):
    """A run whose program buffer holds ``spans`` and whose slice trace
    holds ``events`` (device=None: no slice)."""
    monkeypatch.setattr(program_spans, "SCRATCH", str(tmp_path))

    def make(events, spans, device=True, buffer=True):
        buf = {"spans": spans, "dropped": 0, "clock": (MONO0, REAL0)}
        monkeypatch.setattr(program_spans, "_fetch",
                            lambda: buf if buffer else None)
        with open(tmp_path / "slice_trace.json", "w") as f:
            json.dump({"baseTimeNanoseconds": BASE, "traceEvents": events}, f)
        if device:
            from anns_bench.stats import union_length

            h = (min(min(a for a, _ in _busy(events)),
                     min(e["ts"] for e in events)),
                 max(b for _, b in _busy(events)))
            device = {"busy_s": union_length(_busy(events)) * 1e-6,
                      "window_s": (h[1] - h[0]) * 1e-6}
        t_send = min(s.t0 for s in spans) / 1e9 if spans else 0.0
        return types.SimpleNamespace(
            reqs=[types.SimpleNamespace(t_send=t_send)],
            deadline=max((s.t1 for s in spans), default=0) / 1e9 + 1,
            device=device or None)

    return make


def _read(name, run):
    return load_reader(name)(run)


def test_triage_readers_on_a_known_slice(run_of, tmp_path):
    run = run_of(*_search_slice())
    assert _read("engine.launch_ms.triage", run) == pytest.approx(0.5)
    assert _read("engine.prep_ms.program", run) == pytest.approx(1.9)
    assert _read("wire.self_ms.triage.program", run) == pytest.approx(0.3)
    assert _read("engine.launches.triage", run) == pytest.approx(2.5)
    # slice 890-12600 µs, busy 950 µs; idle inside the roots: 3500 + 3700
    got = _read("device.idle_in_program_pct.triage", run)
    assert got == pytest.approx(100 * 7200 / 11710)
    assert got <= _read("device.idle_pct.triage", run)
    with open(tmp_path / "idle_by_span.sift1m-ivfpq-triage.search-b64.json") \
            as f:
        att = json.load(f)
    by = att["idle_ms_by_span"]
    r = "POST /search"
    assert by == pytest.approx({
        f"{r} > engine > prep": 3.8, f"{r} > engine > resolve": 2.5,
        f"{r} > engine > launch": 0.3, f"{r} > wire decode": 0.2,
        f"{r} > wire encode": 0.3, r: 0.1, "outside": 3.56})
    assert sum(by.values()) == pytest.approx(att["idle_ms"])
    assert att["serving_calls"] == 5
    assert att["serving_calls_in_root_share"] == 1.0
    assert att["calls_on_threads_without_spans"] == 2


def test_enc_readers_on_a_known_slice(run_of, tmp_path):
    run = run_of(*_enc_slice())
    assert _read("wire.self_ms.enc.program", run) == pytest.approx(0.4 + 2.0)
    assert _read("he.host_stages_ms", run) == pytest.approx(4.0)
    assert _read("he.program_launches", run) == 4
    # slice 900-11650, busy 40 + 400 + 4 x 100 + 50; roots 1000-11000
    busy = 890
    idle_in = 10000 - 400 - 400
    got = _read("device.idle_in_program_pct.enc", run)
    assert got == pytest.approx(100 * idle_in / 10750)
    assert got <= _read("device.idle_pct.enc", run)
    assert (tmp_path / "idle_by_span.sift1m-bfv-packed.rerank-b64.json") \
        .exists()
    att = program_spans.attribution(program_spans.load(run))
    assert att["idle_ms"] == pytest.approx((10750 - busy) / 1e3)
    assert att["idle_ms_by_span"]["POST /encryptedsearch > encrypted search"
                                  " > device program"] == pytest.approx(1.6)
    assert att["serving_calls_in_root_share"] == pytest.approx(5 / 6)


def test_requests_partly_outside_the_slice_are_not_counted(run_of):
    ev, spans = _search_slice()
    # the slice ends at 6050: the second request lies outside it
    ev = [e for e in ev if e["ts"] < 6000] + [
        _event("cuda_runtime", 5990, 5, 30, OTHER),
        _event("kernel", 6000, 50, 30)]
    run = run_of(ev, spans)
    assert _read("engine.launches.triage", run) == 3
    assert _read("engine.launch_ms.triage", run) == pytest.approx(0.5)


def test_spans_before_the_window_are_left_out(run_of):
    ev, spans = _search_slice()
    run = run_of(ev, spans)
    run.reqs[0].t_send = _ns(7000) / 1e9        # the window opens late
    assert _read("engine.launches.triage", run) == 2


@pytest.mark.parametrize("name", TRIAGE + ENC)
@pytest.mark.parametrize("case", ["no recorder", "no spans", "no slice"])
def test_a_run_with_nothing_to_read_reads_nothing(run_of, name, case):
    ev, spans = (_search_slice() if name in TRIAGE else _enc_slice())
    if case == "no recorder":
        run = run_of(ev, spans, buffer=False)
    elif case == "no spans":
        run = run_of(ev, [])
    else:
        run = run_of(ev, spans, device=False)
    got = _read(name, run)
    if case == "no slice" and name not in FROM_SLICE:
        assert got is not None and got > 0
    else:
        assert got is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from prefhetch_tpu_torch.utils import stages

    monkeypatch.delattr(stages, "recorded_spans")
    assert program_spans._fetch() is None


def test_launches_read_nothing_when_no_call_is_on_the_spans_thread(run_of):
    """Calls the slice gives another thread id than the spans' (the trace
    keys CUDA calls by CUPTI's thread id, not the native id) count nothing:
    the launch readers read nothing rather than 0."""
    ev, spans = _search_slice()
    run = run_of(ev, [s._replace(ident=4242) for s in spans])
    assert _read("engine.launches.triage", run) is None
    att = program_spans.attribution(program_spans.load(run))
    assert att["serving_calls"] == 0
    assert att["serving_calls_in_root_share"] is None


@pytest.mark.parametrize("ident,tid", [
    ((0x7F12 << 32) | 0x22BFE6C0, 0x22BFE6C0),
    ((0x7F12 << 32) | 0xF33FF6C0, 0x0CC00940),     # read as int32, unsigned
])
def test_cuda_calls_are_matched_by_cupti_thread_id(run_of, ident, tid):
    """The slice writes a thread's CUDA calls under the low 32 bits of its
    pthread_self() read as a signed int32 with the sign dropped (the H100's
    torch 2.11); the spans keep threading.get_ident()."""
    ev, spans = _search_slice()
    ev = [dict(e, tid=tid) if e["tid"] == TID else e for e in ev]
    run = run_of(ev, [s._replace(ident=ident) for s in spans])
    assert _read("engine.launches.triage", run) == pytest.approx(2.5)
    assert program_spans.cupti_tid(tid) == program_spans.cupti_tid(ident)
