"""Port parity: HEComputeService (engine/hecompute.py) and the encrypted
re-rank slice as a whole (binary /coarsesearch top-k → /encryptedsearch →
decrypt) against the JAX package.

All integer: tolerance zero. The JAX service runs its jitted device program
(``backend="tpu"``) on CPU JAX, as tests/test_hecompute_backends.py does;
the port runs its torch program on CPU tensors, where kernel K2's wrapper
takes the plain version. The numpy twins are the independent oracle."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from prefhetch_tpu.client.he import HEClient as JClient
from prefhetch_tpu.data.synthetic import make_clustered_dataset
from prefhetch_tpu.engine.hecompute import HEComputeService as JService
from prefhetch_tpu.engine.server import QueryEngine as JEngine
from prefhetch_tpu.index.build import build_ivf_index
from prefhetch_tpu.serve.handlers import Dispatcher as JDispatcher
from prefhetch_tpu.utils import wire_bin
from prefhetch_tpu.utils.config import (
    HEParams, IndexParams, PipelineConfig, ProtocolParams,
)
from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.crypto.params import bfv_params_for
from prefhetch_tpu_torch.engine.hecompute import HEComputeService as TService
from prefhetch_tpu_torch.engine.server import QueryEngine as TEngine
from prefhetch_tpu_torch.index.build import index_from_numpy
from prefhetch_tpu_torch.ops import ntt4_fused, ntt4_step
from prefhetch_tpu_torch.serve.handlers import Dispatcher as TDispatcher
from prefhetch_tpu_torch.utils import config as tcfg
from prefhetch_tpu_torch.utils.wire import unpack_i32

torch.set_num_threads(1)

D, N = 32, 256
FIELDS = ("centroids", "list_ids", "list_sizes", "list_norms", "list_codes",
          "codebooks", "list_recon", "list_vectors")


def _he(**kw) -> tcfg.HEParams:
    return tcfg.HEParams(n=N, t_bits=24, n_limbs=2, **kw)


# -- the service -------------------------------------------------------------

@pytest.fixture(scope="module")
def svc_setup():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (400, D)).astype(np.float32)
    base[7] = -base[7]                    # signed data: the negative lift
    q = rng.integers(0, 256, (3, D)).astype(np.float32)
    cand = rng.integers(0, 400, (3, 20))  # P=20: not a multiple of B=8
    cand[0, 0] = 7
    return base, q, cand


@pytest.mark.parametrize("mode", ["full", "q1"])
def test_service_matches_jax_device_program_and_numpy_twin(svc_setup, mode):
    base, q, cand = svc_setup
    client = HEClient(_he(sparse_h=32 if mode == "q1" else None), seed=5)
    wires = client.encrypt_query_batch(q)
    p = client.params
    ts = TService(p, device="cpu")
    ts.set_base(base)
    js = JService(bfv_params_for(N, 24, 2), backend="tpu")   # jitted, on CPU
    js.set_base(base)
    cts_t = [ts.ctx.ct_from_wire(w) for w in wires]
    cts_j = [js.ctx.ct_from_wire(w) for w in wires]
    plain_calls = ntt4_step.ntt4_step_plain.calls
    launches = ntt4_fused.ntt4_transform.launches
    if mode == "full":
        bt, nt = ts.encrypted_scores_trunc_async(cts_t, cand)
        bj, nj = js.encrypted_scores_trunc_async(cts_j, cand)
        per_limb = 4
    else:
        bt, nt = ts.encrypted_scores_trunc_q1_async(cts_t, cand)
        bj, nj = js.encrypted_scores_trunc_q1_async(cts_j, cand)
        per_limb = 6
    # K2's plain version per request: 2 stages per transform; on CPU all
    # through the plain version and none through the kernel
    assert ntt4_step.ntt4_step_plain.calls == plain_calls + 2 * per_limb
    assert ntt4_fused.ntt4_transform.launches == launches
    assert bt.dtype == torch.int32
    bt = bt.numpy()
    nb, B = 3, N // D
    assert bt.shape == ((3, nb, 2, N + B) if mode == "full"
                        else (3, nb, N + B))
    np.testing.assert_array_equal(bt, np.asarray(bj))
    np.testing.assert_array_equal(nt, nj)
    ctq, pad_idx, _ = ts.prepare(cts_t, cand)
    assert pad_idx.shape == (3, nb * B) and (pad_idx[:, 20:] == 400).all()
    if mode == "full":
        c1, c0 = ts._trunc_mac_numpy(ctq[:, 0], ctq[:, 1], pad_idx)
        np.testing.assert_array_equal(bt, np.concatenate([c1, c0], -1))
        got = client.decrypt_scores_trunc(*ts.trunc_unbundle(bt, nt), q)
    else:
        np.testing.assert_array_equal(
            bt, ts._trunc_mac_q1_numpy(ctq[:, 0], ctq[:, 1], pad_idx))
        got = client.decrypt_scores_trunc_q1(
            *ts.trunc_unbundle_q1(bt, nt), q)
    np.testing.assert_array_equal(
        got, ((base[cand] - q[:, None]) ** 2).sum(-1))


def test_service_accepts_a_tensor_base_and_coefficient_domain_cts(svc_setup):
    base, q, cand = svc_setup
    client = HEClient(_he(), seed=9)
    a = TService(client.params, device="cpu")
    a.set_base(base)
    b = TService(client.params, device="cpu")
    b.set_base(torch.from_numpy(base))
    assert b._base_dev.dtype == torch.int32 and b._base_dev.shape == (401, D)
    assert not b._base_dev[-1].any()
    cts = [a.ctx.ct_from_wire(w) for w in client.encrypt_query_batch(q)]
    coeff = [a.ctx.from_ntt(c) for c in cts]      # the service re-NTTs them
    ra = a.encrypted_scores_trunc(cts, cand)
    rb = b.encrypted_scores_trunc(coeff, cand)
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(RuntimeError, match="set_base"):
        TService(client.params, device="cpu").encrypted_scores_trunc(cts, cand)
    three = TService(bfv_params_for(N, 24, 3), device="cpu")
    three.set_base(base)
    with pytest.raises(ValueError, match="2 RNS limbs"):
        three.encrypted_scores_trunc_q1_async(cts, cand)


# -- the slice as a whole ------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    data = make_clustered_dataset(
        nbase=2048, ntrain=4000, nquery=8, d=D, n_clusters=40, gt_k=50,
        seed=9,
    )
    cfg = PipelineConfig(
        index=IndexParams(d=D, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=6, coarse_probe=40, k=10, nquery=4),
        he=HEParams(n=N, t_bits=24, n_limbs=2),
        nbase=2048,
    )
    idx = build_ivf_index(data["train"], data["base"], cfg.index)
    arrays = {f: np.asarray(getattr(idx, f)) for f in FIELDS
              if getattr(idx, f) is not None}
    t_cfg = tcfg.PipelineConfig.from_json(cfg.to_json())
    je = JEngine(cfg)
    je.serve_tile = 64
    je.set_index(idx, data["base"])
    te = TEngine(t_cfg, device="cpu")
    te.serve_tile = 64
    te.set_index(index_from_numpy(arrays, t_cfg.index, device="cpu"),
                 data["base"])
    q = data["query"].astype(np.float32)[:4]
    cents = np.asarray(idx.centroids)
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6]
    return je, te, q, probes, data["base"]


BIN = {"content-type": wire_bin.CONTENT_TYPE}


def _he_mode(monkeypatch, je, te, resp_mod):
    """Both engines configured for ``resp_mod``, their HE services built
    anew from that configuration on first use."""
    for e in (je, te):
        monkeypatch.setattr(e, "config", dataclasses.replace(
            e.config, he=dataclasses.replace(e.config.he, resp_mod=resp_mod)))
    if hasattr(je, "_he_service"):
        del je._he_service
    te._he_service = None


@pytest.mark.parametrize("resp_mod", ["full", "packed"])
def test_he_service_params_follow_the_response_mode(engines, monkeypatch,
                                                    resp_mod):
    """The port's engine builds its BFV service with the JAX engine's
    parameters: an odd t under respMod="packed", 2^24 otherwise."""
    je, te, q, probes, base = engines
    _he_mode(monkeypatch, je, te, resp_mod)
    pj, pt = je.he_service.params, te.he_service.params
    assert (pt.n, pt.t, pt.qs) == (pj.n, pj.t, pj.qs)
    assert pt.t == (1 << 24) + (resp_mod == "packed")
    te._he_service = None


def _coarse_topk(disp, q, probes, k):
    req = wire_bin.encode(wire_bin.KIND_COARSE_TOPK_REQ, [
        q, probes.astype(np.int64), np.array([k], np.uint32)])
    status, ctype, body = disp.handle("POST", "/coarsesearch", BIN, req)
    assert status == 200 and ctype == wire_bin.CONTENT_TYPE, body[:200]
    kind, secs = wire_bin.decode(body)
    assert kind == wire_bin.KIND_COARSE_TOPK
    return secs


def test_coarse_topk_matches_jax(engines):
    je, te, q, probes, base = engines
    ids_t, d_t, cnt_t = _coarse_topk(TDispatcher(te), q, probes, 40)
    ids_j, d_j, cnt_j = _coarse_topk(JDispatcher(je), q, probes, 40)
    assert ids_t.dtype == np.int32 and d_t.dtype == np.float32
    assert ids_t.shape == (4, 40)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    # f32 sums in another order: rtol 1e-5; ids equal where no tie
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
    assert (np.diff(d_t, axis=1) >= 0).all()
    for r in range(4):
        assert len(set(ids_t[r]) & set(ids_j[r])) >= 39
    np.testing.assert_array_equal(
        *(e.coarse_search_topk(q, probes, 5)[0] for e in (te, te)))
    with pytest.raises(ValueError, match="candidates < k"):
        te.coarse_search_topk(q, probes, 100000)
    td = TDispatcher(te)
    bad = wire_bin.encode(wire_bin.KIND_COARSE_TOPK_REQ, [
        q, probes.astype(np.int64), np.array([0], np.uint32)])
    assert td.handle("POST", "/coarsesearch", BIN, bad)[0] == 400
    tiled = wire_bin.encode(wire_bin.KIND_COARSE_REQ,
                            [q, probes.astype(np.int64)])
    # the tiled kind and the JSON wire answer since they were ported
    # (tests/test_torch_serve.py holds their answers)
    assert td.handle("POST", "/coarsesearch", BIN, tiled)[0] == 200
    assert td.handle("POST", "/coarsesearch", {}, b"{}")[0] == \
        JDispatcher(je).handle("POST", "/coarsesearch", {}, b"{}")[0] == 400


@pytest.mark.parametrize("mode,jax_backend", [
    ("full", "tpu"), ("full", "numpy"), ("q1", "tpu"),
    ("packed", "tpu"), ("packed", "numpy"),
])
def test_encrypted_search_same_json_as_jax_and_exact(engines, monkeypatch,
                                                     mode, jax_backend):
    """/coarsesearch top-k → /encryptedsearch → decrypt. The port's JSON
    equals the JAX Dispatcher's byte for byte for the same body (its jitted
    device program and its host path), and the decrypted distances equal
    precise_search on the same candidates exactly. Packed: 4 queries with
    G = 6 a response ct (not a multiple), Galois keys sent once per keyId,
    and each package's client decrypts the other's server's answer."""
    je, te, q, probes, base = engines
    monkeypatch.setenv("PFH_HE_BACKEND", jax_backend)
    _he_mode(monkeypatch, je, te, mode)
    td, jd = TDispatcher(te), JDispatcher(je)
    cand = _coarse_topk(td, q, probes, 40)[0]
    client = HEClient(_he(sparse_h=32 if mode == "q1" else None,
                          resp_mod=mode), seed=17)
    body = {
        "encryptedPreciseQuery": client.encrypt_query_batch(q),
        "nearestCoarseVectorIndexes": cand.tolist(),
    }
    if mode != "full":
        body["respMod"] = mode
    if mode == "packed":
        body["keyId"] = client.key_id
        body["galoisKeys"] = client.bfv_extraction_keys_wire(D)
    raw = json.dumps(body)
    # privacy contract: no plaintext query in the request
    assert "preciseQuery" not in raw and '"c0"' in raw
    for row in q:
        assert json.dumps(row.tolist())[1:40] not in raw
    ra = td.handle("POST", "/encryptedsearch", {}, raw.encode())
    rb = jd.handle("POST", "/encryptedsearch", {}, raw.encode())
    assert ra[0] == rb[0] == 200 and ra[1] == rb[1] == "application/json"
    assert ra[2] == rb[2]                       # every field, bit for bit
    out_t, out_j = json.loads(ra[2]), json.loads(rb[2])
    assert out_t == out_j
    norms = np.asarray(out_t["candidateNorms"])
    if mode == "packed":
        assert set(out_t) == {"packedScores", "candidateNorms", "packGroup"}
        assert out_t["packGroup"] == 6 and len(out_t["packedScores"]) == 1
        got = client.decrypt_scores_packed(out_t["packedScores"], norms, q,
                                           out_t["packGroup"])
        jclient = JClient(HEParams(n=N, resp_mod="packed"), seed=17)
        np.testing.assert_array_equal(jclient.decrypt_scores_packed(
            out_t["packedScores"], norms, q, out_t["packGroup"]), got)
        # the keys went once: a second request names the keyId only
        assert client.bfv_extraction_keys_wire(D) is None
        body2 = {**body, "encryptedPreciseQuery":
                 client.encrypt_query_batch(q[::-1])}
        del body2["galoisKeys"]
        raw2 = json.dumps(body2).encode()
        ra2 = td.handle("POST", "/encryptedsearch", {}, raw2)
        assert ra2 == jd.handle("POST", "/encryptedsearch", {}, raw2)
        out2 = json.loads(ra2[2])
        np.testing.assert_array_equal(
            client.decrypt_scores_packed(out2["packedScores"], norms, q[::-1],
                                         out2["packGroup"]),
            ((base[cand] - q[::-1, None]) ** 2).sum(-1))
    else:
        c1_key = "c1Ntt" if mode == "full" else "c1Q1"
        assert set(out_t) == {c1_key, "c0Ip", "candidateNorms"}
        c1, c0 = unpack_i32(out_t[c1_key]), unpack_i32(out_t["c0Ip"])
        if mode == "full":
            got = client.decrypt_scores_trunc(c1, c0, norms, q)
        else:
            got = client.decrypt_scores_trunc_q1(c1, c0, norms, q)
    np.testing.assert_array_equal(got, te.precise_search(q, cand))
    np.testing.assert_array_equal(
        got, ((base[cand] - q[:, None]) ** 2).sum(-1))


def test_encrypted_search_errors(engines):
    je, te, q, probes, base = engines
    td, jd = TDispatcher(te), JDispatcher(je)
    client = HEClient(_he(), seed=1)
    wires = client.encrypt_query_batch(q[:2])
    cand = [[1, 2, 3], [4, 5, 6]]
    ok = {"encryptedPreciseQuery": wires, "nearestCoarseVectorIndexes": cand}
    for bad in (
        {**ok, "nearestCoarseVectorIndexes": cand[:1]},      # nq mismatch
        {**ok, "nearestCoarseVectorIndexes": [[1, 2, 99999]] * 2},
        {**ok, "nearestCoarseVectorIndexes": [[-1, 2, 3]] * 2},
        {"nearestCoarseVectorIndexes": cand},                # missing field
    ):
        raw = json.dumps(bad).encode()
        assert td.handle("POST", "/encryptedsearch", {}, raw)[0] == \
            jd.handle("POST", "/encryptedsearch", {}, raw)[0] == 400
    assert td.handle("POST", "/encryptedsearch", {}, b"{nope")[0] == 400
    # scheme="ckks" is served (tests/test_torch_ckks_route.py): without
    # Galois keys for its keyId it is refused as the JAX package refuses it
    raw = json.dumps({**ok, "scheme": "ckks"}).encode()
    st_t, _, msg_t = td.handle("POST", "/encryptedsearch", {}, raw)
    st_j, _, msg_j = jd.handle("POST", "/encryptedsearch", {}, raw)
    assert st_t == st_j == 400
    assert json.loads(msg_t) == json.loads(msg_j)
    assert "CKKS keyId" in json.loads(msg_t)["error"]
    # respMod="packed" is served, and refused as the JAX package refuses it
    # without Galois keys for its keyId, with a wrong keyId, and with keys
    # whose digitBits disagree with their shape
    gks = HEClient(_he(resp_mod="packed"), seed=1).bfv_extraction_keys_wire(D)
    for extra, word in (
            ({}, "keyId"), ({"keyId": "nope"}, "keyId"),
            ({"keyId": "k", "galoisKeys": {
                g: dict(w, digitBits=15) for g, w in gks.items()}},
             "digitBits")):
        raw = json.dumps({**ok, "respMod": "packed", **extra}).encode()
        st_t, _, msg_t = td.handle("POST", "/encryptedsearch", {}, raw)
        st_j, _, msg_j = jd.handle("POST", "/encryptedsearch", {}, raw)
        assert st_t == st_j == 400
        assert json.loads(msg_t) == json.loads(msg_j)
        assert word in json.loads(msg_t)["error"]
    with pytest.raises(ValueError, match="keyId"):
        te.encrypted_precise_search(wires, np.asarray(cand),
                                    resp_mod="packed")
    with pytest.raises(ValueError, match="CKKS keyId"):
        te.encrypted_precise_search(wires, np.asarray(cand), scheme="ckks")
    with pytest.raises(ValueError, match="respMod"):
        te.encrypted_precise_search(wires, np.asarray(cand), resp_mod="x")
    status, _, _ = td.handle("POST", "/encryptedsearch", {}, json.dumps(
        {**ok, "respMod": "nonsense"}).encode())
    assert status == 400
    stats = json.loads(td.handle("GET", "/stats", {}, b"")[2])
    assert stats["POST /encryptedsearch"]["errors"] == \
        stats["POST /encryptedsearch"]["count"]


@pytest.mark.parametrize("mode", ["full", "q1", "packed"])
def test_stage_recording_times_the_served_path(engines, mode):
    """record_stages collects the stages of the request Dispatcher.handle
    really serves, in order, and changes nothing of the answer; outside it
    the marks record nothing."""
    from prefhetch_tpu_torch.utils.stages import record_stages, stage

    je, te, q, probes, base = engines
    td = TDispatcher(te)
    cand = _coarse_topk(td, q, probes, 40)[0]
    client = HEClient(_he(sparse_h=32 if mode == "q1" else None,
                          resp_mod=mode), seed=3)
    body = {
        "encryptedPreciseQuery": client.encrypt_query_batch(q),
        "nearestCoarseVectorIndexes": cand.tolist(), "respMod": mode,
    }
    stages = [
        "json parse", "shape and range checks",
        "ct_from_wire (c1 expansion + host NTT)",
        "prepare (stack, pad, norms)", "upload", "device program",
        "download", "pack_i32", "json.dumps"]
    if mode == "packed":
        # the keys go with the first request of a keyId, which also builds
        # their device tables; the request recorded after it names the
        # keyId only, and the c1 mask never leaves the device program
        body["keyId"] = client.key_id
        with record_stages() as first:
            want = td.handle("POST", "/encryptedsearch", {}, json.dumps(
                {**body, "galoisKeys": client.bfv_extraction_keys_wire(D)}
            ).encode())
        assert list(first)[2] == "register galois keys"
        assert "galois key tables (host NTT, once per key)" in first
        stages = [
            "json parse", "shape and range checks",
            "wire decode (c0 + seeds)", "prepare (pad, norms)", "upload",
            "device program", "download", "to_wire (base64)", "json.dumps"]
    raw = json.dumps(body).encode()
    if mode != "packed":
        want = td.handle("POST", "/encryptedsearch", {}, raw)
    with record_stages() as times:
        got = td.handle("POST", "/encryptedsearch", {}, raw)
    assert got == want and got[0] == 200
    assert list(times) == stages
    assert all(ms >= 0 for ms in times.values())
    n = len(times)
    with stage("not recorded"):
        td.handle("POST", "/encryptedsearch", {}, raw)
    assert len(times) == n


# -- the Galois machinery shared by the three HE device programs ------------

@pytest.fixture(scope="module")
def galois_setup():
    """The packed service and DevicePIR2 on one BFV ring (N=256, the PIR
    preset's two limbs; d=32, so the packed service's five extraction
    elements are the PIR expansion's first five) and DeviceCKKS at N=256
    with three limbs, with a key wire for each."""
    from prefhetch_tpu_torch.crypto import ckks as tckks
    from prefhetch_tpu_torch.crypto import pir as tpir
    from prefhetch_tpu_torch.crypto.params import (
        CKKSParams, find_ntt_primes, pir_params_for,
    )
    from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

    rng = np.random.default_rng(17)
    p = pir_params_for(N, 257, 2)
    base = rng.integers(0, 256, (300, D)).astype(np.float32)
    pir_client = tpir.PIRClient(p, seed=6)
    pir_wire = pir_client.galois_keys_wire_2d_multi(300, D, 2)   # depth 5
    wide = pir_client.ctx.galois_keygen(pir_client.sk, [N + 1], rng,
                                        digit_bits=30)[N + 1]
    packed = TService(p, device="cpu")
    packed.set_base(base)
    pir = DevicePIR2(base, p, device="cpu")
    qs = tuple(find_ntt_primes(N, 30, 3))
    ctx = tckks.CKKSContext(CKKSParams(n=N, scale_bits=20, qs=qs))
    sk, _ = ctx.keygen(rng)
    ckks_wire = {str(s): k.to_wire()
                 for s, k in ctx.galois_keygen(sk, [1, 2], rng).items()}
    two = tckks.CKKSContext(CKKSParams(n=N, scale_bits=20, qs=qs[:2]))
    two_key = two.galois_keygen(two.keygen(rng)[0], [1], rng)[1]
    ckks = DeviceCKKS(ctx.params, device="cpu")
    return {
        "packed": (packed, packed.register_galois_keys,
                   packed.has_galois_keys, pir_wire, wide),
        "pir": (pir, pir.register_galois_keys, pir.has_keys, pir_wire,
                wide),
        "ckks": (ckks, ckks.register_keys, ckks.has_keys, ckks_wire,
                 two_key),
    }


@pytest.mark.parametrize("service", ["packed", "ckks", "pir"])
@pytest.mark.parametrize("bad", ["basis", "shape", "digitBits"])
def test_galois_key_intake_refusals(galois_setup, service, bad):
    """One key of a set on another basis, at another N, or declaring a
    digit width its component count does not have is refused by each of
    the three registrations (engine/hecompute.py ``check_galois_keys``),
    as a ValueError, and the keyId stays unknown. A CKKS key names no
    basis: the other basis is a key of a two-limb context."""
    from prefhetch_tpu_torch.crypto.bfv import RelinKey
    from prefhetch_tpu_torch.crypto.ckks import GaloisKey

    _, register, has, wire, other = galois_setup[service]
    first = next(iter(wire))
    load = GaloisKey.from_wire if service == "ckks" else RelinKey.from_wire
    key = load(wire[first])
    if bad == "basis" and service == "ckks":
        key = other
    elif bad == "basis":
        key.ext = key.ext[:-1] + (key.ext[-1] - 2,)
    elif bad == "shape":
        key.b, key.a = key.b[..., :N // 2], key.a[..., :N // 2]
    elif service == "ckks":
        key.digit_bits = 30               # 15-bit components
    else:
        key = other                       # 30-bit components, said 15
        key.digit_bits = 15
    if service == "ckks":
        key.step = int(first)
    bad_wire = {**wire, first: key.to_wire()}
    key_id = f"bad-{bad}"
    with pytest.raises(ValueError, match="digitBits" if bad == "digitBits"
                       else "does not match"):
        register(key_id, bad_wire)
    assert not has(key_id)


def test_packed_and_pir_put_one_key_on_the_device_alike(galois_setup):
    """The same RelinKeys registered with the packed service and with
    DevicePIR2 become equal int32 tables on the device, with equal
    automorphisms, through the one intake."""
    packed, *_, wire, _ = galois_setup["packed"]
    pir = galois_setup["pir"][0]
    packed.register_galois_keys("same", wire)
    pir.register_galois_keys("same", wire)
    got = packed._packed_rotations("same")
    want = pir._keys["same"]
    assert got.kb.dtype == got.ka.dtype == torch.int32
    assert got.kb.shape == (5, 4, 3, N)
    assert torch.equal(got.kb, want.kb) and torch.equal(got.ka, want.ka)
    assert torch.equal(got.perm, want.perm[:5])
    assert torch.equal(got.neg, want.neg[:5])
    assert got.digit_bits == want.digit_bits == 15


def _seam_request(service):
    """One small request of each HE device program on the CPU: a packed
    seedTf request (3 queries, 20 candidates, d=32), a CKKS per-block
    request (one query, 10 candidates) and a 2-row PIR fetch."""
    from prefhetch_tpu_torch.crypto import ckks as tckks
    from prefhetch_tpu_torch.crypto import pir as tpir
    from prefhetch_tpu_torch.crypto.params import (
        CKKSParams, find_ntt_primes, pir_params_for,
    )
    from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

    rng = np.random.default_rng(3)
    if service == "packed":
        client = HEClient(tcfg.HEParams(n=N, resp_mod="packed"), seed=1)
        svc = TService(client.params, device="cpu")
        svc.set_base(rng.integers(0, 256, (300, D)).astype(np.float32))
        svc.register_galois_keys("k", client.bfv_extraction_keys_wire(D))
        q = rng.integers(0, 256, (3, D)).astype(np.float64)
        cand = rng.integers(0, 300, (3, 20))
        wires = client.encrypt_query_batch(q)
        return lambda: svc.encrypted_scores_packed_wire(wires, cand, "k")
    if service == "ckks":
        params = CKKSParams(n=N, scale_bits=20,
                            qs=tuple(find_ntt_primes(N, 30, 3)))
        ctx = tckks.CKKSContext(params)
        sk, pk = ctx.keygen(rng)
        gks = ctx.galois_keygen(sk, tckks.rotation_steps(D), rng)
        dev = DeviceCKKS(params, device="cpu")
        dev.register_keys("k", {str(s): k.to_wire() for s, k in gks.items()})
        qv = rng.integers(0, 30, D).astype(np.float64)
        ct = ctx.encrypt(pk, ctx.encode(np.tile(qv, N // 2 // D)), rng)
        cands = rng.integers(0, 30, (10, D)).astype(np.float64)
        return lambda: dev.encrypted_scores(ct, cands, "k")
    p = pir_params_for(N, 257, 2)
    base = rng.integers(0, 256, (300, D)).astype(np.float32)
    client = tpir.PIRClient(p, seed=6)
    dev = DevicePIR2(base, p, device="cpu")
    dev.register_galois_keys("k", client.galois_keys_wire_2d_multi(300, D, 2))
    wire, _ = client.build_query_2d_multi([5, 250], 300, D)
    return lambda: dev.answer_2d_multi(wire, "k", 2)


def _k2(kind, rows, dtype):
    return (kind, (rows, N), dtype)


# every transform that resolves through engine/hecompute.py's ``ntt4`` and
# ``intt4``, in order: the names the benchmark's traced run patches (its
# NTT replay keeps the first calls through them)
_SEAM = {
    # seeded c1 a limb; MAC a limb (M = 9 rows); 5 extraction rounds of
    # 3 primes (30-bit keys: 2 digit rows a row; the key switch's digits
    # and sums int32, ops/key_switch.py); the shift-pack a limb
    "packed": ([_k2("ntt4", 3, torch.int64)] * 2
               + [_k2("ntt4", 9, torch.int32),
                  _k2("intt4", 18, torch.int64)] * 2
               + [_k2("ntt4", 18, torch.int32),
                  _k2("intt4", 18, torch.int32)] * 15
               + [_k2("ntt4", 18, torch.int64),
                  _k2("intt4", 2, torch.int64)] * 2),
    # 5 rotations at level 2 (3 blocks, 15-bit keys: 4 digit rows a
    # block), each 3 primes; the ct×pt transforms are ckks_device's own
    "ckks": [_k2("ntt4", 12, torch.int32), _k2("intt4", 6, torch.int32)] * 15,
    # 5 expansion rounds of 3 primes over 2^(j+1) int32 cts; the folds'
    # transforms are pir_device's own
    "pir": [c for j in range(5)
            for c in [_k2("ntt4", 8 << j, torch.int32),
                      _k2("intt4", 4 << j, torch.int32)] * 3],
}


@pytest.mark.parametrize("service", ["packed", "ckks", "pir"])
def test_key_switch_transforms_resolve_through_hecompute(service,
                                                         monkeypatch):
    """Counting wrappers over engine/hecompute.py's ``ntt4`` and ``intt4``
    (where the benchmark's traced run patches them) see every key-switch
    transform of one request of each HE device program, and only those of
    the packed program besides: their number, order, rows and dtypes."""
    from prefhetch_tpu_torch.engine import hecompute

    go = _seam_request(service)
    seen = []
    for name in ("ntt4", "intt4"):
        real = getattr(hecompute, name)

        def counting(x, tb, *rest, _name=name, _real=real):
            seen.append((_name, tuple(x.shape), x.dtype))
            return _real(x, tb, *rest)

        monkeypatch.setattr(hecompute, name, counting)
    go()
    assert len(seen) == len(_SEAM[service])
    assert seen == _SEAM[service]
