"""Port parity: private row retrieval (crypto/pir.py, engine/pir_device.py)
against the JAX package, bit for bit.

Same fixtures as tests/test_pir.py (N=256, t=257, two 30-bit limbs, d=32,
byte-valued rows from a seeded numpy generator): ``pack_database``, the
``PIRClient`` wires from the same seed, ``expand_query(_batch)``, the host
servers ``PIR2Server`` and ``PIRServer``, and ``DevicePIR2(device="cpu")``
(K2's plain version) against the JAX ``DevicePIR2`` (jitted on the CPU):
its packed database, its key stacks and the response wires of all four
answer forms. Every decoded row equals its base row. One single-row answer
runs at the served ring, N=4096 with nbase 5,000 and d=128, against the
port's ``PIR2Server``."""

import numpy as np
import pytest
import torch

from prefhetch_tpu.crypto import pir as J
from prefhetch_tpu.crypto.bfv import Ciphertext as JCiphertext
from prefhetch_tpu.crypto.bfv import RelinKey as JRelinKey
from prefhetch_tpu.crypto.params import pir_params_for as j_params
from prefhetch_tpu.engine.pir_device import DevicePIR2 as JDevicePIR2
from prefhetch_tpu_torch.crypto import pir as T
from prefhetch_tpu_torch.crypto.bfv import Ciphertext
from prefhetch_tpu_torch.crypto.params import pir_params_for
from prefhetch_tpu_torch.engine import pir_device
from prefhetch_tpu_torch.engine.pir_device import DevicePIR2
from prefhetch_tpu_torch.ops import ntt4 as ntt4_mod

torch.set_num_threads(1)

NBASE, D = 300, 32              # R=8, G=38, g1=7, g2=6, m=13, logm=4


@pytest.fixture(scope="module")
def setup():
    p = pir_params_for(256, 257, 2)
    assert p.qs == j_params(256, 257, 2).qs
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (NBASE, D)).astype(np.float32)
    client = T.PIRClient(p, seed=6)
    dev = DevicePIR2(base, p, device="cpu")
    host = T.PIR2Server(base, p)
    return p, base, client, dev, host


@pytest.fixture(scope="module")
def jax_dev(setup):
    """The JAX DevicePIR2 on the same base, with the port client's keys
    (single-row and 3-row multi depth) under two ids."""
    p, base, client, _, _ = setup
    jdev = JDevicePIR2(base, j_params(256, 257, 2))
    jdev.register_galois_keys("single", client.galois_keys_wire_2d(NBASE, D))
    jdev.register_galois_keys(
        "multi", client.galois_keys_wire_2d_multi(NBASE, D, 3))
    return jdev


def _count_transforms(monkeypatch):
    """Count K2 transforms on the CPU (the wrapper counts card launches)."""
    calls = [0]
    real = ntt4_mod.ntt4_transform

    def counting(x, tb, inverse):
        calls[0] += 1
        return real(x, tb, inverse)

    monkeypatch.setattr(ntt4_mod, "ntt4_transform", counting)
    return calls


# -- numpy module ------------------------------------------------------------

def test_pack_database_matches_jax(setup):
    p, base, _, _, _ = setup
    got = T.pack_database(base, p)
    np.testing.assert_array_equal(got, J.pack_database(base, p))
    assert T.grid_dims(p, NBASE, D) == J.grid_dims(p, NBASE, D) == (38, 7, 6)
    assert T.rows_per_block(p, D) == J.rows_per_block(p, D) == 8


@pytest.mark.parametrize("bad", ["fraction", "range"])
def test_pack_database_refusals_match_jax(setup, bad):
    p, base, _, _, _ = setup
    b = base[:20].copy()
    if bad == "fraction":
        b[3, 4] += 0.5
    else:
        b[3, 4] = 257
    with pytest.raises(ValueError) as je:
        J.pack_database(b, p)
    with pytest.raises(ValueError) as te:
        T.pack_database(b, p)
    assert str(te.value) == str(je.value)


_WIRE_FORMS = {
    "naive": lambda c: c.build_query(37, NBASE, D),
    "packed": lambda c: c.build_query_packed(37, NBASE, D),
    "2d": lambda c: c.build_query_2d(299, NBASE, D),
    "multi": lambda c: c.build_query_2d_multi([0, 37, 299], NBASE, D),
    "keys_packed": lambda c: c.galois_keys_wire(NBASE, D),
    "keys_2d": lambda c: c.galois_keys_wire_2d(NBASE, D),
    "keys_multi": lambda c: c.galois_keys_wire_2d_multi(NBASE, D, 3),
}


@pytest.mark.parametrize("form", list(_WIRE_FORMS))
def test_client_wires_match_jax(form):
    """The same seed gives the same keys and the same query and key wires;
    only the uuid key_id differs."""
    jc = J.PIRClient(j_params(256, 257, 2), seed=11)
    tc = T.PIRClient(pir_params_for(256, 257, 2), seed=11)
    np.testing.assert_array_equal(tc.sk.s_rns, jc.sk.s_rns)
    np.testing.assert_array_equal(tc.pk.b_rns, jc.pk.b_rns)
    assert _WIRE_FORMS[form](tc) == _WIRE_FORMS[form](jc)
    assert tc.rows_per_ct(NBASE, D) == jc.rows_per_ct(NBASE, D) == 19


def test_expand_query_matches_jax(setup):
    """expand_query (depth-first, bit-reversed back) and expand_query_batch
    (breadth-first) give the JAX selectors, and each selector decrypts to
    2^logm·a_b."""
    p, _, client, _, _ = setup
    m = 13
    gw = client.galois_keys_wire_2d(NBASE, D)
    poly = np.zeros(p.n, np.int64)
    poly[[2, 7, 12]] = 1
    ct = client.ctx.encrypt(client.pk, poly, np.random.default_rng(3))
    tgk = {int(g): T.RelinKey.from_wire(w) for g, w in gw.items()}
    jgk = {int(g): JRelinKey.from_wire(w) for g, w in gw.items()}
    jct = JCiphertext.from_wire(ct.to_wire())
    jctx = J.BFVContext(j_params(256, 257, 2))
    outs = T.expand_query(client.ctx, ct, m, tgk)
    jouts = J.expand_query(jctx, jct, m, jgk)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o.c0, jo.c0)
        np.testing.assert_array_equal(o.c1, jo.c1)
    s0, s1 = T.expand_query_batch(client.ctx, ct, m, tgk)
    j0, j1 = J.expand_query_batch(jctx, jct, m, jgk)
    np.testing.assert_array_equal(s0, j0)
    np.testing.assert_array_equal(s1, j1)
    assert T.expansion_galois_elements(p.n, m) == \
        J.expansion_galois_elements(p.n, m)
    inv = pow(16, -1, p.t)
    for b in range(m):
        dec = client.ctx.decrypt(client.sk, Ciphertext(c0=s0[b], c1=s1[b]))
        assert dec[0] * inv % p.t == poly[b]
        assert not np.any(dec[1:] * inv % p.t)


def test_pir2server_matches_jax(setup):
    p, base, client, _, host = setup
    jhost = J.PIR2Server(base, j_params(256, 257, 2))
    np.testing.assert_array_equal(host.db_ntt, jhost.db_ntt)
    gw = client.galois_keys_wire_2d_multi(NBASE, D, 3)
    host.register_galois_keys("k", gw)
    jhost.register_galois_keys("k", gw)
    w, r = client.build_query_2d(123, NBASE, D)
    resp = host.answer_2d(w, "k")
    assert resp == jhost.answer_2d(w, "k")
    np.testing.assert_array_equal(client.decode_response_2d(resp, D, r),
                                  base[123])
    rows = [0, 37, 299]
    wm, rs = client.build_query_2d_multi(rows, NBASE, D)
    multi = host.answer_2d_multi(wm, "k", 3)
    assert multi == jhost.answer_2d_multi(wm, "k", 3)
    for row, resp, r in zip(rows, multi, rs):
        np.testing.assert_array_equal(client.decode_response_2d(resp, D, r),
                                      base[row])
    with pytest.raises(ValueError, match="bad n_rows"):
        host.answer_2d_multi(wm, "k", 20)


def test_pirserver_matches_jax(setup):
    """The naive (G selector cts) and 1-D packed forms: the JAX response
    wires, exact rows, and the naive form's count refusal."""
    p, base, client, _, _ = setup
    jp = j_params(256, 257, 2)
    srv, jsrv = T.PIRServer(base, p), J.PIRServer(base, jp)
    np.testing.assert_array_equal(srv.db_ntt, jsrv.db_ntt)
    q = client.build_query(55, NBASE, D)
    resp = srv.answer(q)
    assert resp == jsrv.answer(q)
    np.testing.assert_array_equal(client.decode_response(resp, D), base[55])
    with pytest.raises(ValueError, match="must carry"):
        srv.answer(q[:-1])
    gw = client.galois_keys_wire(NBASE, D)
    srv.register_galois_keys("k", gw)
    jsrv.register_galois_keys("k", gw)
    assert srv.has_keys("k") and not srv.has_keys("other")
    w, r = client.build_query_packed(99, NBASE, D)
    resp = srv.answer_packed(w, "k")
    assert resp == jsrv.answer_packed(w, "k")
    np.testing.assert_array_equal(
        client.decode_block_response(resp, D, r, srv.n_blocks), base[99])


# -- the device program ------------------------------------------------------

def test_device_db_and_keys_match_jax(setup, jax_dev):
    """The packed database (transformed by K2 into four-step order) and the
    key stacks (host NTT, then the four-step permutation) equal the JAX
    program's arrays."""
    _, _, client, dev, _ = setup
    np.testing.assert_array_equal(dev.db.numpy(), np.asarray(jax_dev.db))
    assert dev.db.shape == (7, 6, 2, 256) and dev.db.dtype == torch.int32
    dev.register_galois_keys("multi",
                             client.galois_keys_wire_2d_multi(NBASE, D, 3))
    for t, j in zip(dev._keys["multi"], jax_dev._keys["multi"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (dev.g1, dev.g2, dev.m, dev.logm, dev.logm_max) == \
        (jax_dev.g1, jax_dev.g2, jax_dev.m, jax_dev.logm, jax_dev.logm_max)
    assert dev.rows_per_ct() == jax_dev.rows_per_ct() == 19


def test_device_answer_2d_matches_jax(setup, jax_dev, monkeypatch):
    p, base, client, dev, host = setup
    dev.register_galois_keys("single", client.galois_keys_wire_2d(NBASE, D))
    host.register_galois_keys("single", client.galois_keys_wire_2d(NBASE, D))
    w, r = client.build_query_2d(123, NBASE, D)
    calls = _count_transforms(monkeypatch)
    resp = dev.answer_2d(w, "single")
    assert calls[0] == 6 * 4 + 4 * 2          # 6·logm + 4·L
    assert resp == jax_dev.answer_2d(w, "single")
    assert resp == host.answer_2d(w, "single")
    np.testing.assert_array_equal(client.decode_response_2d(resp, D, r),
                                  base[123])


def test_device_answer_2d_batch_matches_jax(setup, jax_dev, monkeypatch):
    """3 single-row queries in one program: the JAX program's wire for
    each query (its batched form is held to that by tests/test_pir.py),
    the same transform count as one query, and exact rows."""
    _, base, client, dev, _ = setup
    dev.register_galois_keys("single", client.galois_keys_wire_2d(NBASE, D))
    rows = [5, 299, 5]
    wires, rs = zip(*(client.build_query_2d(r, NBASE, D) for r in rows))
    calls = _count_transforms(monkeypatch)
    got = dev.answer_2d_batch(list(wires), "single")
    assert calls[0] == 32
    assert got == [jax_dev.answer_2d(w, "single") for w in wires]
    for row, resp, r in zip(rows, got, rs):
        np.testing.assert_array_equal(client.decode_response_2d(resp, D, r),
                                      base[row])


def test_device_answer_2d_multi_matches_jax(setup, jax_dev, monkeypatch):
    """One 3-row ct: a 6-level expansion (3·13 = 39 selectors), logF 6,
    6·6 + 8 transforms."""
    _, base, client, dev, _ = setup
    dev.register_galois_keys("multi",
                             client.galois_keys_wire_2d_multi(NBASE, D, 3))
    rows = [0, 37, 299]
    w, rs = client.build_query_2d_multi(rows, NBASE, D)
    calls = _count_transforms(monkeypatch)
    got = dev.answer_2d_multi(w, "multi", 3)
    assert calls[0] == 6 * 6 + 8
    want = jax_dev.answer_2d_multi(w, "multi", 3)
    assert got == want and [g["logF"] for g in got] == [6, 6, 6]
    for row, resp, r in zip(rows, got, rs):
        np.testing.assert_array_equal(client.decode_response_2d(resp, D, r),
                                      base[row])


def test_device_answer_2d_multi_batch_matches_jax(setup, jax_dev,
                                                  monkeypatch):
    """5 cts of 3 rows with a cap of 2 cts a program (MAX_EXPANDED = 128,
    2^6 selectors each): chunks 2 + 2 + 1, every response bit-equal to
    the JAX program's answer of its ct."""
    _, base, client, dev, _ = setup
    dev.register_galois_keys("multi",
                             client.galois_keys_wire_2d_multi(NBASE, D, 3))
    chunks = [[0, 37, 299], [123, 1, 2], [250, 250, 44], [7, 8, 9],
              [298, 0, 150]]
    wires, rads = zip(*(client.build_query_2d_multi(c, NBASE, D)
                        for c in chunks))
    monkeypatch.setattr(pir_device, "MAX_EXPANDED", 128)
    calls = _count_transforms(monkeypatch)
    got = dev.answer_2d_multi_batch(list(wires), "multi", 3)
    assert calls[0] == 3 * 44
    assert len(got) == 15
    assert got == [r for w in wires
                   for r in jax_dev.answer_2d_multi(w, "multi", 3)]
    k = 0
    for ch, rs in zip(chunks, rads):
        for row, r in zip(ch, rs):
            np.testing.assert_array_equal(
                client.decode_response_2d(got[k], D, r), base[row])
            k += 1


def test_device_concurrent_multi_row_fetches_run_one_program_at_a_time(
        setup, monkeypatch):
    """Two multi-row fetches from two threads at once (as the threaded
    frontends serve them): the service runs one answer program at a time,
    so its device memory is one program's, and each fetch gets the
    responses it gets alone."""
    import threading
    import time

    _, base, client, dev, _ = setup
    dev.register_galois_keys("multi",
                             client.galois_keys_wire_2d_multi(NBASE, D, 3))
    reqs = [[[0, 37, 299], [123, 1, 2]], [[250, 250, 44], [7, 8, 9]]]
    wires = [[client.build_query_2d_multi(c, NBASE, D)[0] for c in r]
             for r in reqs]
    alone = [dev.answer_2d_multi_batch(w, "multi", 3) for w in wires]
    active, peak = [0], [0]
    real = dev._program

    def program(*args):
        active[0] += 1
        peak[0] = max(peak[0], active[0])
        time.sleep(0.2)               # let the other thread reach the card
        try:
            return real(*args)
        finally:
            active[0] -= 1

    monkeypatch.setattr(dev, "_program", program)
    got = [None, None]
    barrier = threading.Barrier(2)

    def fetch(i):
        barrier.wait()
        got[i] = dev.answer_2d_multi_batch(wires[i], "multi", 3)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert peak[0] == 1
    assert got == alone


def test_device_multi_row_depth_guards(setup):
    """Single-row keys are refused for a deeper multi-row expansion; n_rows
    beyond ⌊N/m⌋ is refused at build and at answer time; keys shallower
    than logm are refused at registration (tests/test_pir.py:289)."""
    _, _, _, dev, _ = setup
    client = T.PIRClient(pir_params_for(256, 257, 2), seed=26)
    dev.register_galois_keys("guards", client.galois_keys_wire_2d(NBASE, D))
    k_ct = dev.rows_per_ct()
    with pytest.raises(ValueError, match="rows need"):
        client.build_query_2d_multi([0] * (k_ct + 1), NBASE, D)
    wire, _ = client.build_query_2d_multi([0] * k_ct, NBASE, D)
    with pytest.raises(ValueError, match="levels"):
        dev.answer_2d_multi(wire, "guards", k_ct)
    with pytest.raises(ValueError, match="outside"):
        dev.answer_2d_multi(wire, "guards", k_ct + 1)
    shallow = dict(list(client.galois_keys_wire_2d(NBASE, D).items())[:2])
    with pytest.raises(ValueError, match="even the single-row tree"):
        dev.register_galois_keys("shallow", shallow)
    assert not dev.has_keys("shallow")


def test_device_keys_no_downgrade(setup):
    """A shallower re-registration of the SAME client's keys keeps the
    deeper stack; a different client's keys under the id overwrite it
    (tests/test_pir.py:395)."""
    _, base, _, dev, _ = setup
    client = T.PIRClient(pir_params_for(256, 257, 2), seed=42)
    dev.register_galois_keys(
        "nd", client.galois_keys_wire_2d_multi(NBASE, D, 3))
    deep = dev._keys["nd"][0].shape[0]
    dev.register_galois_keys("nd", client.galois_keys_wire_2d(NBASE, D))
    assert dev._keys["nd"][0].shape[0] == deep == 6
    w, rs = client.build_query_2d_multi([0, 37, 299], NBASE, D)
    for row, resp, r in zip([0, 37, 299], dev.answer_2d_multi(w, "nd", 3),
                            rs):
        np.testing.assert_array_equal(client.decode_response_2d(resp, D, r),
                                      base[row])
    other = T.PIRClient(pir_params_for(256, 257, 2), seed=99)
    dev.register_galois_keys("nd", other.galois_keys_wire_2d(NBASE, D))
    assert dev._keys["nd"][0].shape[0] == 4
    w2, r2 = other.build_query_2d(37, NBASE, D)
    np.testing.assert_array_equal(
        other.decode_response_2d(dev.answer_2d(w2, "nd"), D, r2), base[37])


@pytest.mark.parametrize("bad", ["digit_bits", "ext", "special_p"])
def test_device_refuses_unusable_keys(setup, bad):
    """The device key switch takes 15-bit digits over the service's own
    extension basis: other keys are refused at registration (the JAX
    program assumes them and does not check)."""
    p, _, _, dev, _ = setup
    client = T.PIRClient(p, seed=7)
    elts = T.expansion_galois_elements(p.n, dev.m)
    if bad == "digit_bits":
        gks = client.ctx.galois_keygen(client.sk, elts, client._rng,
                                       digit_bits=30)
        wire = {str(g): k.to_wire() for g, k in gks.items()}
    else:
        wire = client.galois_keys_wire_2d(NBASE, D)
        first = dict(wire[str(elts[0])])
        if bad == "ext":
            first["ext"] = list(first["ext"][:2]) + [first["ext"][2] - 2]
        else:
            first["specialP"] = first["specialP"] - 2
        wire = {**wire, str(elts[0]): first}
    with pytest.raises(ValueError, match="digitBits" if bad == "digit_bits"
                       else "does not match"):
        dev.register_galois_keys("bad-" + bad, wire)
    assert not dev.has_keys("bad-" + bad)


@pytest.mark.parametrize("k", [1, 7])
def test_device_answer_2d_sharded_matches_answer_2d(setup, monkeypatch, k):
    """The database sharded over the dim-1 fold (g1=7 rows; meshes of 1
    and 7 CPU shards): the answer equals answer_2d, with as many K2
    transforms, and decodes to its row; a mesh of 2 is refused with the JAX
    package's text."""
    from prefhetch_tpu_torch.parallel.mesh import make_mesh

    _, base, client, dev, _ = setup
    dev.register_galois_keys("single", client.galois_keys_wire_2d(NBASE, D))
    w, r = client.build_query_2d(200, NBASE, D)
    want = dev.answer_2d(w, "single")
    calls = _count_transforms(monkeypatch)
    got = dev.answer_2d_sharded(w, "single", make_mesh(devices=["cpu"] * k))
    assert calls[0] == 6 * 4 + 4 * 2
    assert got == want
    np.testing.assert_array_equal(client.decode_response_2d(got, D, r),
                                  base[200])
    with pytest.raises(ValueError, match="g1=7 not divisible by 2 devices"):
        dev.answer_2d_sharded(w, "single", make_mesh(devices=["cpu"] * 2))


def test_device_answer_at_served_ring():
    """N=4096, t=257, nbase 5,000, d=128 (the engine's HEParams defaults):
    one single-row answer of DevicePIR2 on the CPU equals the port's
    PIR2Server and decodes to the exact row."""
    p = pir_params_for(4096, 257, 2)
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (5000, 128)).astype(np.float32)
    client = T.PIRClient(p, seed=5)
    dev = DevicePIR2(base, p, device="cpu")
    host = T.PIR2Server(base, p)
    assert (dev.g1, dev.g2, dev.logm) == (13, 13, 5)
    gw = client.galois_keys_wire_2d(5000, 128)
    dev.register_galois_keys("k", gw)
    host.register_galois_keys("k", gw)
    w, r = client.build_query_2d(4321, 5000, 128)
    resp = dev.answer_2d(w, "k")
    assert resp == host.answer_2d(w, "k")
    assert resp["nDigits"] == 4 and len(resp["cts"]) == 8
    np.testing.assert_array_equal(client.decode_response_2d(resp, 128, r),
                                  base[4321])
