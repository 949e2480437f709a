"""Port parity: CKKS over ``POST /encryptedsearch`` (``scheme="ckks"``), the
slice as a whole, against the JAX package, per-block and "combined".

``QueryEngine(device="cpu")`` runs ``DeviceCKKS`` on K2's plain version;
the JAX engine on the CPU answers with its numpy ``CKKSComputeService``.
Requests cross both ways: the JAX ``HEClient``'s request answered by the
port's ``Dispatcher`` and decrypted by the JAX client, and the port's
``HEClient`` (through the port's ``ClientPipeline`` stage 6) against the
JAX ``Dispatcher`` and against the port's. Tolerances are the JAX e2e
suite's (tests/test_encrypted_e2e.py): per-block rtol 2e-3, atol 20;
combined within 8% of the row's largest distance, with at least 8 of the
top 10 shared. The per-block response is host-encoded in both packages,
so its JSON is the JAX package's byte for byte."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from prefhetch_tpu.client.he import HEClient as JClient
from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.engine.server import QueryEngine as JEngine
from prefhetch_tpu.index.build import build_ivf_index
from prefhetch_tpu.serve.handlers import Dispatcher as JDispatcher
from prefhetch_tpu.utils.config import (
    HEParams, IndexParams, PipelineConfig, ProtocolParams,
)
from prefhetch_tpu_torch.client.he import HEClient as TClient
from prefhetch_tpu_torch.client.pipeline import ClientPipeline
from prefhetch_tpu_torch.crypto import ckks as T
from prefhetch_tpu_torch.engine.server import QueryEngine as TEngine
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.ops import ntt4_fused, ntt4_step
from prefhetch_tpu_torch.serve.handlers import Dispatcher as TDispatcher
from prefhetch_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

D, N, CP = 32, 256, 40
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")


@pytest.fixture(scope="module")
def engines():
    data = make_clustered_dataset(
        nbase=2048, ntrain=4000, nquery=8, d=D, n_clusters=40, gt_k=50,
        seed=19,
    )
    cfg = PipelineConfig(
        index=IndexParams(d=D, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=6, coarse_probe=CP, k=10, nquery=4,
                                encrypted_rerank=True),
        he=HEParams(scheme="ckks", n=N, n_limbs=3),
        nbase=2048,
    )
    idx = build_ivf_index(data["train"], data["base"], cfg.index)
    arrays = {f: np.asarray(getattr(idx, f)) for f in FIELDS
              if getattr(idx, f) is not None}
    t_cfg = tcfg.PipelineConfig.from_json(cfg.to_json())
    je = JEngine(cfg)
    je.set_index(idx, data["base"])
    te = TEngine(t_cfg, device="cpu")
    te.set_index(index_from_numpy(arrays, t_cfg.index, device="cpu"),
                 data["base"])
    q = data["query"].astype(np.float32)[:4]
    base = data["base"]
    # each query's CP nearest base rows, plus a far one: the candidates a
    # coarse round would name
    d2 = ((q[:, None].astype(np.float64) - base[None]) ** 2).sum(-1)
    cand = np.argsort(d2, axis=1, kind="stable")[:, :CP]
    cand[:, -1] = np.argmax(d2, axis=1)
    return je, te, q, cand, base


def _ckks(mode):
    return dict(scheme="ckks", n=N, n_limbs=3, resp_mod=mode)


def _exact(base, cand, q):
    return ((base[cand].astype(np.float64) - q[:, None]) ** 2).sum(-1)


def _assert_close(got, want, mode):
    """The JAX e2e suite's tolerances."""
    assert got.shape == want.shape and got.dtype == np.float32
    if mode == "full":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=20.0)
        return
    row_max = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 0.08 * row_max).all()
    for i in range(got.shape[0]):
        top = set(np.argsort(got[i])[:10].tolist())
        assert len(top & set(np.argsort(want[i])[:10].tolist())) >= 8


def _send(disp):
    def send(method, route, body):
        status, _, out = disp.handle(method, "/" + route, {}, body)
        assert status == 200, out[:300]
        return out
    return send


def _body(client, q, cand, mode, keys=True):
    body = {"scheme": "ckks", "keyId": client.key_id,
            "encryptedPreciseQuery": client.encrypt_query_batch(q),
            "nearestCoarseVectorIndexes": cand.tolist()}
    nb = 1
    if mode == "combined":
        body["respMod"] = "combined"
        nb = client.combine_blocks(CP, D)
    if keys:
        body["galoisKeys"] = client.galois_keys_wire(D, nb)
    return body


@pytest.mark.parametrize("mode", ["full", "combined"])
def test_jax_client_request_answered_by_the_port(engines, mode):
    """The JAX HEClient's request (public-key wires per block; seedTf
    wires and the combine-tree keys for "combined") answered by the port's
    Dispatcher and decrypted by the JAX client. Per-block: the port's JSON
    is the JAX Dispatcher's byte for byte. Combined: one level-1 ct a
    query, the norms the JAX engine's."""
    je, te, q, cand, base = engines
    jc = JClient(HEParams(**_ckks(mode)), seed=31)
    raw = json.dumps(_body(jc, q, cand, mode)).encode()
    assert b"preciseQuery" not in raw
    st_t, ct_t, out_t = TDispatcher(te).handle("POST", "/encryptedsearch",
                                               {}, raw)
    st_j, _, out_j = JDispatcher(je).handle("POST", "/encryptedsearch",
                                            {}, raw)
    assert st_t == st_j == 200 and ct_t == "application/json"
    resp, resp_j = json.loads(out_t), json.loads(out_j)
    assert set(resp) == set(resp_j)
    assert resp["candidateNorms"] == resp_j["candidateNorms"]
    norms = np.asarray(resp["candidateNorms"], np.int64)
    if mode == "full":
        assert out_t == out_j                     # every byte
        assert len(resp["encryptedScores"][0]) == -(-CP // ((N // 2) // D))
        got = jc.decrypt_scores_batch(resp["encryptedScores"], norms, q)
    else:
        cts = resp["encryptedScoresCombined"]
        assert len(cts) == len(q) and all(c["level"] == 1 for c in cts)
        got = jc.decrypt_scores_combined(cts, norms, q)
    _assert_close(got, _exact(base, cand, q), mode)


@pytest.mark.parametrize("mode", ["full", "combined"])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_port_client_pipeline(engines, server, mode):
    """The port's ClientPipeline stage 6 with the port's HEClient against
    the JAX Dispatcher and against the port's, in-process: the Galois keys
    go with the first request only, and the decrypted distances are within
    the tolerances. On the port's server every transform of the device
    program is one call of K2's wrapper (plain version on CPU tensors):
    6 ct×pt, 2 a prime of each rotation's key switch, 4 for the mask."""
    je, te, q, cand, base = engines
    disp = JDispatcher(je) if server == "jax" else TDispatcher(te)
    cfg = dataclasses.replace(
        te.config, he=dataclasses.replace(te.config.he, resp_mod=mode))
    pipe = ClientPipeline(cfg, send=_send(disp))
    tc = TClient(tcfg.HEParams(**_ckks(mode)), seed=37)
    sorted_coarse = [(np.zeros(CP, np.float32), c) for c in cand]
    sent = []
    post = pipe._post

    def spy(route, payload):
        sent.append(payload)
        return post(route, payload)

    pipe._post = spy
    ntt4_step.ntt4_step_plain.calls = 0
    ntt4_fused.ntt4_transform.launches = 0
    got, got_cand = pipe.get_encrypted_precise_scores(sorted_coarse, q,
                                                      he_client=tc)
    np.testing.assert_array_equal(got_cand, cand)
    _assert_close(got, _exact(base, cand, q), mode)
    assert "galoisKeys" in sent[0]
    assert sent[0].get("respMod") == ("combined" if mode == "combined"
                                      else None)
    if server == "port":
        # log2(D) = 5 strides; combined: 16 blocks, W = 2, strides 16..2
        # before the combine, 4 tree rounds, stride 1 after it
        n_pre = 5 if mode == "full" else 4
        rot = {"full": n_pre * 3 * 2,
               "combined": n_pre * 3 * 2 + 4 * 2 * 2 + 1 * 2 * 2}[mode]
        mask = 4 if mode == "combined" else 0
        assert ntt4_fused.ntt4_transform.launches == 0
        assert ntt4_step.ntt4_step_plain.calls == 2 * (6 + rot + mask)
    got2, _ = pipe.get_encrypted_precise_scores(sorted_coarse, q[::-1],
                                                he_client=tc)
    assert "galoisKeys" not in sent[1]
    _assert_close(got2, _exact(base, cand, q[::-1]), mode)


def test_ckks_refusals_match_jax(engines):
    """An unknown keyId and a level-2 query for the combined response:
    HTTP 400 with the JAX package's text, from both Dispatchers."""
    je, te, q, cand, base = engines
    td, jd = TDispatcher(te), JDispatcher(je)
    jc = JClient(HEParams(**_ckks("full")), seed=41)
    body = _body(jc, q[:2], cand[:2], "full", keys=False)
    body["keyId"] = "nope"
    raw = json.dumps(body).encode()
    out = [d.handle("POST", "/encryptedsearch", {}, raw) for d in (td, jd)]
    assert out[0][0] == out[1][0] == 400
    assert json.loads(out[0][2]) == json.loads(out[1][2]) == {
        "error": "unknown CKKS keyId — register Galois keys first"}
    # register keys under a keyId, then send level-2 query cts
    reg = json.dumps(_body(jc, q[:2], cand[:2], "full")).encode()
    for d in (td, jd):
        assert d.handle("POST", "/encryptedsearch", {}, reg)[0] == 200
    low = []
    for w in body["encryptedPreciseQuery"]:
        ct = T.CKKSCiphertext.from_wire(w)
        low.append(dict(T.CKKSCiphertext(
            c0=ct.c0[:2], c1=ct.c1[:2], level=2, scale=ct.scale).to_wire(),
            scheme="ckks"))
    raw = json.dumps({**body, "keyId": jc.key_id, "respMod": "combined",
                      "encryptedPreciseQuery": low}).encode()
    out = [d.handle("POST", "/encryptedsearch", {}, raw) for d in (td, jd)]
    assert out[0][0] == out[1][0] == 400
    assert json.loads(out[0][2]) == json.loads(out[1][2]) == {
        "error": "combined scoring needs a level-3 query ct"}
