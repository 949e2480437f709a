"""The span recorder of utils/stages.py on the served path (CPU): one span
tree per request through ``Dispatcher.handle``, nothing recorded and the
same bytes answered outside ``record_stages()``, the stages of
``/encryptedsearch`` under its ``encrypted search`` span while
``record_stages()`` yields what it always did, the clock pair that maps a
span onto a ``torch.profiler`` trace, and the bounded buffer.

This file imports only torch and the port."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
from prefhetch_tpu_torch.engine.server import QueryEngine
from prefhetch_tpu_torch.index.build import build_ivf_index
from prefhetch_tpu_torch.serve.handlers import Dispatcher
from prefhetch_tpu_torch.utils import stages, wire_bin
from prefhetch_tpu_torch.utils.config import (
    HEParams, IndexParams, PipelineConfig, ProtocolParams,
)

torch.set_num_threads(1)

D, NPROBE, CP, K = 32, 6, 40, 10
BIN = {"content-type": wire_bin.CONTENT_TYPE,
       "accept": wire_bin.CONTENT_TYPE}


@pytest.fixture(scope="module")
def served():
    data = make_clustered_dataset(nbase=2048, ntrain=4000, nquery=8, d=D,
                                  n_clusters=40, gt_k=50, seed=9)
    cfg = PipelineConfig(
        index=IndexParams(d=D, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=NPROBE, coarse_probe=CP, k=K,
                                nquery=4),
        he=HEParams(n=256, t_bits=24, n_limbs=2, resp_mod="packed"),
        nbase=2048,
    )
    eng = QueryEngine(cfg, device="cpu")
    eng.serve_tile = 64
    eng.set_index(build_ivf_index(data["train"], data["base"], cfg.index,
                                  device="cpu"), data["base"])
    q = data["query"].astype(np.float32)[:4]
    cents = eng.retrieve_centroids()
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :NPROBE].astype(np.int64)
    return Dispatcher(eng), q, probes


def _search_body(q, probes):
    return wire_bin.encode(wire_bin.KIND_SEARCH_REQ,
                           [q, probes, np.array([K], np.uint32)])


def _coarse_body(q, probes):
    return wire_bin.encode(wire_bin.KIND_COARSE_TOPK_REQ,
                           [q, probes, np.array([CP], np.uint32)])


ROUTES = {"/search": _search_body, "/coarsesearch": _coarse_body}


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.t0)


def test_marks_are_one_shared_no_op_while_recording_is_off():
    stages.clear_spans()
    assert stages.span("a") is stages.span("b") is stages.stage("c")
    with stages.span("a"), stages.stage("c"):
        pass
    assert stages.recorded_spans()["spans"] == []


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_recording_off_records_nothing_and_answers_the_same_bytes(served,
                                                                  route):
    disp, q, probes = served
    body = ROUTES[route](q, probes)
    stages.clear_spans()
    off = disp.handle("POST", route, BIN, body)
    assert off[0] == 200
    assert stages.recorded_spans()["spans"] == []
    with stages.record_stages() as times:
        on = disp.handle("POST", route, BIN, body)
    assert on == off
    assert times == {}                 # spans never enter the stage dict
    assert stages.recorded_spans()["spans"]


def test_another_threads_recording_leaves_this_thread_unrecorded(served):
    disp, q, probes = served
    stages.clear_spans()
    started, done = threading.Event(), threading.Event()

    def recorder():
        with stages.record_stages():
            started.set()
            done.wait(timeout=60)

    t = threading.Thread(target=recorder)
    t.start()
    try:
        assert started.wait(timeout=60)
        disp.handle("POST", "/search", BIN, _search_body(q, probes))
    finally:
        done.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert stages.recorded_spans()["spans"] == []


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_binary_route_gives_one_span_tree_a_request(served, route):
    disp, q, probes = served
    body = ROUTES[route](q, probes)
    stages.clear_spans()
    with stages.record_stages():
        for _ in range(2):
            assert disp.handle("POST", route, BIN, body)[0] == 200
    rec = stages.recorded_spans()
    spans = rec["spans"]
    assert rec["dropped"] == 0 and rec["clock"] is not None
    roots = sorted((s for s in spans if s.parent == 0), key=lambda s: s.t0)
    assert [r.name for r in roots] == [f"POST {route}"] * 2
    assert roots[0].request != roots[1].request
    assert roots[0].t1 <= roots[1].t0
    for root in roots:
        assert root.request == root.id
        mine = [s for s in spans if s.request == root.request]
        assert len(mine) == 7
        top = _children(mine, root)
        assert [s.name for s in top] == ["wire decode", "engine",
                                         "wire encode"]
        assert [s.name for s in _children(mine, top[1])] == [
            "prep", "launch", "resolve"]
        by_id = {s.id: s for s in mine}
        for s in mine:
            assert s.tid == threading.get_native_id()
            assert s.ident == threading.get_ident()
            assert s.t0 <= s.t1
            if s is not root:
                p = by_id[s.parent]
                assert p.t0 <= s.t0 and s.t1 <= p.t1


def test_encrypted_search_puts_the_stages_under_its_span(served):
    disp, q, probes = served
    ids = wire_bin.decode(disp.handle("POST", "/coarsesearch", BIN,
                                      _coarse_body(q, probes))[2])[1][0]
    client = HEClient(disp.engine.config.he, seed=3)
    body = {"encryptedPreciseQuery": client.encrypt_query_batch(q),
            "nearestCoarseVectorIndexes": ids.tolist(), "respMod": "packed",
            "keyId": client.key_id}
    keys = dict(body, galoisKeys=client.bfv_extraction_keys_wire(D))
    want = disp.handle("POST", "/encryptedsearch", {},
                       json.dumps(keys).encode())
    assert want[0] == 200, want[2][:200]
    stages.clear_spans()
    with stages.record_stages() as times:
        got = disp.handle("POST", "/encryptedsearch", {},
                          json.dumps(body).encode())
    assert got == want
    inner = ["wire decode (c0 + seeds)", "prepare (pad, norms)", "upload",
             "device program", "download", "to_wire (base64)"]
    assert list(times) == ["json parse", "shape and range checks", *inner,
                           "json.dumps"]
    spans = stages.recorded_spans()["spans"]
    (root,) = [s for s in spans if s.parent == 0]
    assert root.name == "POST /encryptedsearch"
    top = _children(spans, root)
    assert [s.name for s in top] == ["json parse", "shape and range checks",
                                     "encrypted search", "json.dumps"]
    assert [s.name for s in _children(spans, top[2])] == inner
    assert {s.request for s in spans} == {root.id}


def test_record_function_maps_inside_its_span(tmp_path):
    """A span's stamps, mapped with the recording's clock pair onto the
    trace's clock, hold a record_function range opened inside the span on
    the recording thread (0.5 ms of slack)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    stages.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stages.record_stages():
            with stages.span("outer"):
                time.sleep(0.002)
                with record_function("inner.range"):
                    time.sleep(0.005)
                time.sleep(0.002)
    rec = stages.recorded_spans()
    (s,) = rec["spans"]
    mono0, real0 = rec["clock"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    (r,) = [e for e in trace["traceEvents"]
            if e.get("name") == "inner.range" and e.get("ph") == "X"]
    t0, t1 = ((t - mono0 + real0 - base) / 1e3 for t in (s.t0, s.t1))
    assert r["tid"] == s.tid
    assert t0 - 500 <= r["ts"] and r["ts"] + r["dur"] <= t1 + 500
    assert r["ts"] - t0 >= 2000 - 500    # the range is where it ran


def test_a_full_buffer_counts_its_drops(monkeypatch):
    stages.clear_spans()
    monkeypatch.setattr(stages._buffer, "cap", 3)
    with stages.record_stages():
        for i in range(5):
            with stages.span(f"s{i}"):
                pass
    rec = stages.recorded_spans()
    assert [s.name for s in rec["spans"]] == ["s0", "s1", "s2"]
    assert rec["dropped"] == 2
    rec["spans"].clear()                   # a copy: the buffer keeps its own
    assert len(stages.recorded_spans()["spans"]) == 3
    stages.clear_spans()
    rec = stages.recorded_spans()
    assert rec["spans"] == [] and rec["dropped"] == 0
