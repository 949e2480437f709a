"""Port parity: ``POST /pir-fetch`` and the client's stage 8 under
``pir_mode="he"``, the slice as a whole, against the JAX package.

The fixture is tests/test_pir_e2e.py's (a SIFT-style set of 256 rows,
d=32, N=256, t=257). The port's engine runs ``QueryEngine(device="cpu")``,
whose hypercube service is ``DevicePIR2`` on K2's plain version; the JAX
engine on the CPU answers with its numpy ``PIR2Server``. The JSON of all
four body forms is the JAX Dispatcher's byte for byte, and so are the
refusals. Over HTTP, ``ClientPipeline.run()`` fetches exact rows with no
index in the request; the JAX client against the port's server and the
port's client against the JAX server do too."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from prefhetch_tpu.client.pipeline import ClientPipeline as JPipeline
from prefhetch_tpu.engine.server import QueryEngine as JEngine
from prefhetch_tpu.serve.handlers import Dispatcher as JDispatcher
from prefhetch_tpu.serve.http_server import make_server as j_make_server
from prefhetch_tpu.utils.config import (
    HEParams, IndexParams, PipelineConfig, ProtocolParams,
)
from prefhetch_tpu_torch.client.pipeline import ClientPipeline
from prefhetch_tpu_torch.client.pir import get_pir_client
from prefhetch_tpu_torch.crypto.params import pir_params_for
from prefhetch_tpu_torch.crypto.pir import PIRClient
from prefhetch_tpu_torch.data.synthetic import write_sift_style_dataset
from prefhetch_tpu_torch.engine.server import QueryEngine as TEngine
from prefhetch_tpu_torch.serve.handlers import Dispatcher as TDispatcher
from prefhetch_tpu_torch.serve.http_server import serve_forever
from prefhetch_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

NBASE, D = 256, 32              # R=8, G=32, g1=g2=6, m=12, 21 rows a ct


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    ds = str(tmp_path_factory.mktemp("ds"))
    write_sift_style_dataset(
        ds, prefix="syn", nbase=NBASE, ntrain=1200, nquery=10, d=D,
        n_clusters=12, gt_k=50, seed=8,
    )
    cfg = PipelineConfig(
        index=IndexParams(d=D, nlist=8, pq_m=0, kmeans_iters=5),
        protocol=ProtocolParams(nprobe=4, coarse_probe=30, k=5, nquery=3,
                                pir_mode="he"),
        he=HEParams(scheme="bfv", n=256, t_bits=24, n_limbs=2,
                    pir_plain_modulus=257),
        nbase=NBASE,
        train_path=os.path.join(ds, "syn_learn.fvecs"),
        base_path=os.path.join(ds, "syn_base.fvecs"),
        query_path=os.path.join(ds, "syn_query.fvecs"),
        groundtruth_path=os.path.join(ds, "syn_groundtruth.ivecs"),
    )
    t_cfg = tcfg.PipelineConfig.from_json(cfg.to_json())
    je = JEngine(cfg, index_dir=str(tmp_path_factory.mktemp("jidx")))
    je.init_index()
    te = TEngine(t_cfg, index_dir=str(tmp_path_factory.mktemp("tidx")),
                 device="cpu")
    te.init_index()
    np.testing.assert_array_equal(te.base.numpy(), np.asarray(je.base))
    tsrv = serve_forever(te, "127.0.0.1", 0, background=True)
    jsrv = j_make_server(je, "127.0.0.1", 0)
    threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    try:
        yield (cfg, t_cfg, je, te,
               f"http://127.0.0.1:{tsrv.server_address[1]}/",
               f"http://127.0.0.1:{jsrv.server_address[1]}/")
    finally:
        tsrv.shutdown()
        tsrv.server_close()
        jsrv.shutdown()
        jsrv.server_close()


def _both(je, te, body):
    raw = json.dumps(body).encode()
    want = JDispatcher(je).handle("POST", "/pir-fetch", {}, raw)
    got = TDispatcher(te).handle("POST", "/pir-fetch", {}, raw)
    return want, got


def _bodies():
    """One body per form, from a fresh client of a fixed seed, each with
    its Galois keys under its own keyId."""
    c = PIRClient(pir_params_for(256, 257, 2), seed=31)
    multi = [{"ct": c.build_query_2d_multi(rows, NBASE, D)[0], "nRows": 3}
             for rows in ([0, 77, 255], [128, 128, 3])]
    return c, {
        "pirHypercubeMulti": {
            "pirHypercubeMulti": multi, "keyId": "m",
            "galoisKeys": c.galois_keys_wire_2d_multi(NBASE, D, 3)},
        "pirHypercube": {
            "pirHypercube": [c.build_query_2d(r, NBASE, D)[0]
                             for r in (9, 200)],
            "keyId": "h", "galoisKeys": c.galois_keys_wire_2d(NBASE, D)},
        "pirPacked": {
            "pirPacked": [c.build_query_packed(40, NBASE, D)[0]],
            "keyId": "p", "galoisKeys": c.galois_keys_wire(NBASE, D)},
        "pirQueries": {"pirQueries": [c.build_query(101, NBASE, D)]},
    }


@pytest.fixture(scope="module")
def bodies():
    return _bodies()


@pytest.mark.parametrize("form", ["pirHypercubeMulti", "pirHypercube",
                                  "pirPacked", "pirQueries"])
def test_pir_fetch_json_matches_jax(served, bodies, form):
    """The same body gives the JAX Dispatcher's bytes, and the responses
    decode to the base rows."""
    _, _, je, te, _, _ = served
    c, all_bodies = bodies
    want, got = _both(je, te, all_bodies[form])
    assert want[0] == got[0] == 200, got[2][:200]
    assert got[2] == want[2]
    res = json.loads(got[2])["pirResults"]
    base = te.base.numpy()
    if form == "pirHypercubeMulti":
        rows = [0, 77, 255, 128, 128, 3]
        assert len(res) == 6 and all(r["logF"] == 6 for r in res)
        for row, resp in zip(rows, res):
            np.testing.assert_array_equal(
                c.decode_response_2d(resp, D, row % 8), base[row])
    elif form == "pirHypercube":
        for row, resp in zip((9, 200), res):
            np.testing.assert_array_equal(
                c.decode_response_2d(resp, D, row % 8), base[row])
    elif form == "pirPacked":
        np.testing.assert_array_equal(
            c.decode_block_response(res[0], D, 0, 32), base[40])
    else:
        np.testing.assert_array_equal(c.decode_response(res[0], D),
                                      base[101])


@pytest.mark.parametrize("body", [
    {"pirHypercube": [{}], "keyId": "never-registered"},
    {"pirHypercubeMulti": [{"ct": {}, "nRows": 1}], "keyId": "nope"},
    {"pirPacked": [{}], "keyId": "nope"},
    {"pirHypercube": []},
    {"pirHypercubeMulti": [{"nRows": 2}]},
    {"pirQueries": "x"},
])
def test_pir_fetch_refusals_match_jax(served, body):
    _, _, je, te, _, _ = served
    want, got = _both(je, te, body)
    assert want[0] == got[0] == 400
    assert got[2] == want[2]


def test_pipeline_real_pir_over_http(served, monkeypatch):
    """The port's ClientPipeline.run() with pir_mode="he" against the
    port's server: exact rows, one multi-row ct a 21 rows with the same
    padded nRows, no index anywhere in the body, keys only once."""
    _, t_cfg, _, te, taddr, _ = served
    client = ClientPipeline(t_cfg, server_addr=taddr)
    captured = {}
    orig = client._post

    def spy(route, payload):
        captured[route] = json.loads(json.dumps(payload))
        return orig(route, payload)

    monkeypatch.setattr(client, "_post", spy)
    vectors, top_ids = client.run()
    np.testing.assert_array_equal(vectors, te.base.numpy()[top_ids])
    body = captured["pir-fetch"]
    assert set(body) == {"pirHypercubeMulti", "keyId", "galoisKeys"}
    entries = body["pirHypercubeMulti"]
    assert len(entries) == 1 and entries[0]["nRows"] == 21
    assert set(entries[0]["ct"]) <= {"c0", "c1", "isNtt", "shape"}
    assert "nearestPreciseVectorIndexes" not in json.dumps(body)
    client.run()
    assert "galoisKeys" not in captured["pir-fetch"]


def test_pipeline_real_pir_single_wire_and_retry(served):
    """``wire="single"``: one pirHypercube ct a row, exact; after the
    server loses the keys (a restart) the client's HTTP 400 re-registers
    and retries once."""
    _, t_cfg, _, te, taddr, _ = served
    client = ClientPipeline(t_cfg, server_addr=taddr)
    ids = np.array([[3, 250, 17, 17, 0], [1, 2, 3, 4, 5]])
    vec, top = client.get_precise_vectors_real_pir(ids, wire="single")
    np.testing.assert_array_equal(vec, te.base.numpy()[ids])
    svc = te.pir2_service
    svc._keys.clear()
    svc._key_fps.clear()
    assert get_pir_client(t_cfg)._keys_registered_single
    vec, _ = client.get_precise_vectors_real_pir(ids[:1], wire="single")
    np.testing.assert_array_equal(vec, te.base.numpy()[ids[:1]])
    vec, _ = client.get_precise_vectors_real_pir(ids[1:])
    np.testing.assert_array_equal(vec, te.base.numpy()[ids[1:]])
    with pytest.raises(ValueError, match="unknown PIR wire"):
        client.get_precise_vectors_real_pir(ids, wire="dense")


def test_jax_client_against_port_server(served):
    cfg, _, _, te, taddr, _ = served
    vectors, top_ids = JPipeline(cfg, server_addr=taddr).run()
    np.testing.assert_array_equal(vectors, te.base.numpy()[top_ids])


def test_port_client_against_jax_server(served):
    _, t_cfg, je, _, _, jaddr = served
    vectors, top_ids = ClientPipeline(t_cfg, server_addr=jaddr).run()
    np.testing.assert_array_equal(vectors, np.asarray(je.base)[top_ids])
