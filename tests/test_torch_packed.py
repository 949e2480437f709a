"""Port parity: the packed single-ct BFV response (``respMod="packed"``)
against the JAX package: Galois keys and key switching (crypto/bfv.py),
the packed client (client/he.py) and the packed program of
engine/hecompute.py, host-expanded entry (the seeded entry is in
tests/test_torch_threefry.py; both at the operating point here).

All integer: tolerance zero. On the JAX side its numpy oracle
(``backend="numpy"``) and its jitted program run on CPU JAX
(``backend="tpu"``), as tests/test_bfv_packed.py runs them; the port runs its
torch program on CPU tensors, where K2's wrapper takes its plain version,
and its own numpy twin."""

import numpy as np
import pytest
import torch

from prefhetch_tpu.client.he import HEClient as JClient
from prefhetch_tpu.crypto import bfv as j_bfv
from prefhetch_tpu.engine.hecompute import HEComputeService as JService
from prefhetch_tpu.utils.config import HEParams as JHEParams
from prefhetch_tpu_torch.client.he import HEClient as TClient
from prefhetch_tpu_torch.crypto import bfv as t_bfv
from prefhetch_tpu_torch.engine.hecompute import HEComputeService as TService
from prefhetch_tpu_torch.ops import ntt4_fused, ntt4_step
from prefhetch_tpu_torch.utils.config import HEParams as THEParams

torch.set_num_threads(1)


def _setup(n, d, seed, nbase=600):
    he = dict(n=n, resp_mod="packed")
    jc = JClient(JHEParams(**he), seed=seed)
    tc = TClient(THEParams(**he), seed=seed)
    base = np.random.default_rng(seed).integers(
        0, 256, (nbase, d)).astype(np.float32)
    gks = tc.bfv_extraction_keys_wire(d)
    assert gks == jc.bfv_extraction_keys_wire(d)     # one seed, one wire
    ts = TService(tc.params, device="cpu")
    jn = JService(jc.params, backend="numpy")
    js = JService(jc.params, backend="tpu")          # jitted, on CPU
    for s in (ts, jn, js):
        s.set_base(base)
        s.register_galois_keys("k", gks)
    return tc, jc, ts, jn, js, base, gks


def _queries(seed, nq, d, p, nbase=600):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (nq, d)).astype(np.float64)
    cand = np.stack([rng.permutation(nbase)[:p] for _ in range(nq)])
    return q, cand


def _assert_same_cts(*outs):
    first = outs[0]
    for other in outs[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            np.testing.assert_array_equal(a.c0, b.c0)
            np.testing.assert_array_equal(a.c1, b.c1)


def _exact(base, cand, q):
    return ((base[cand].astype(np.float64) - q[:, None]) ** 2).sum(-1)


@pytest.fixture(scope="module")
def op_point():
    """The operating point: N=4096, 2 limbs, t = 2^24 + 1, d=128, P=256
    (B=32, nb=8, G=16)."""
    return _setup(4096, 128, seed=41)


@pytest.fixture(scope="module")
def small():
    """The small fixture: N=256, d=32, P=64 (B=8, nb=8, G=4)."""
    return _setup(256, 32, seed=43)


# -- keys and key switching ----------------------------------------------------

def test_keys_and_key_switching_bit_equal():
    """From one seed: the same special prime and basis, the same Galois and
    switch keys (RelinKey wires both ways, both digit widths), the same
    automorphisms, key switches, monomial products and Galois rounds."""
    he = dict(n=256, resp_mod="packed")
    jc = JClient(JHEParams(**he), seed=5)
    tc = TClient(THEParams(**he), seed=5)
    jx, tx = jc.ctx, tc.ctx
    assert tx._special_p == jx._special_p
    assert tx._ext_basis == jx._ext_basis
    assert tx.extraction_elts(256, 32) == jx.extraction_elts(256, 32) \
        == [257, 129, 65, 33, 17]
    with pytest.raises(ValueError, match="power-of-two"):
        tx.extraction_elts(256, 24)
    for g in (129, 9, 3):
        for a, b in zip(tx._automorphism_map(g), jx._automorphism_map(g)):
            np.testing.assert_array_equal(a, b)
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    for bits in (15, 30):
        kt = tx.galois_keygen(tc.sk, [129, 9], rng_t, digit_bits=bits)
        kj = jx.galois_keygen(jc.sk, [129, 9], rng_j, digit_bits=bits)
        for g in (129, 9):
            w = kt[g].to_wire()
            assert w == kj[g].to_wire()
            back = j_bfv.RelinKey.from_wire(w)
            np.testing.assert_array_equal(back.b, kt[g].b)
            assert t_bfv.RelinKey.from_wire(kj[g].to_wire()).to_wire() == w
        assert kt[9].b.shape == (2 * (30 // bits), 3, 256)
        with pytest.raises(ValueError, match="divide"):
            tx._make_switch_key(tc.sk, np.zeros(256), rng_t, digit_bits=7)
        # a ciphertext through the automorphism + key switch, both forms
        q = np.arange(32, dtype=np.float64)
        ct_t = tx.ct_from_wire(tc.encrypt_query_batch(q[None])[0])
        ct_j = j_bfv.Ciphertext(ct_t.c0, ct_t.c1, ct_t.is_ntt)
        for g in (129, 9):
            a, b = tx.apply_galois(ct_t, g, kt[g]), jx.apply_galois(
                ct_j, g, kj[g])
            np.testing.assert_array_equal(a.c0, b.c0)
            np.testing.assert_array_equal(a.c1, b.c1)
            coeff = tx.from_ntt(ct_t)
            c0s = np.stack([coeff.c0, coeff.c1])
            for x, y in zip(tx.apply_galois_batch(c0s, c0s, g, kt[g]),
                            jx.apply_galois_batch(c0s, c0s, g, kj[g])):
                np.testing.assert_array_equal(x, y)
            # the key switch returns a ciphertext of m(X^g) under s
            perm, sgn = tx._automorphism_map(g)
            m = tx.decrypt(tc.sk, ct_t)
            np.testing.assert_array_equal(tx.decrypt(tc.sk, a),
                                          np.mod(m[perm] * sgn, tc.params.t))
        for e in (3, -5, 300):
            a, b = tx.mul_monomial(ct_t, e), jx.mul_monomial(ct_j, e)
            np.testing.assert_array_equal(a.c0, b.c0)
            np.testing.assert_array_equal(a.c1, b.c1)


# -- the packed program --------------------------------------------------------

@pytest.mark.parametrize("nq", [5, 4])
def test_program_bit_equal_to_jax_small(small, nq):
    """Host-expanded entry at N=256/d=32/P=64 (G=4): nq = 5 (the last group
    holds one query; the port computes only the real rows, JAX pads with
    zero ciphertexts) and nq = G."""
    tc, jc, ts, jn, js, base, _ = small
    q, cand = _queries(nq, nq, 32, 64)
    wires = tc.encrypt_query_batch(q)
    cts = [ts.ctx.ct_from_wire(w) for w in wires]
    jcts = [jn.ctx.ct_from_wire(w) for w in wires]
    plain = ntt4_step.ntt4_step_plain.calls
    pt, nt, gt = ts.encrypted_scores_packed(cts, cand, "k")
    # 2L MAC + 2(L+1) for each of log2(32) = 5 rounds + 2L pack transforms,
    # 2 plain stages each on the CPU
    assert ntt4_step.ntt4_step_plain.calls - plain == 2 * (4 + 30 + 4)
    pj, nj, gj = js.encrypted_scores_packed(jcts, cand, "k")
    po, _, _ = jn.encrypted_scores_packed(jcts, cand, "k")
    assert gt == gj == 4 and len(pt) == -(-nq // 4)
    _assert_same_cts(pt, pj, po)
    np.testing.assert_array_equal(nt, nj)
    ctq, pad_idx, _ = ts.prepare(cts, cand)
    twin = ts._packed_mac_numpy(ctq, pad_idx, ts._galois_bfv["k"])
    np.testing.assert_array_equal(
        twin, jn._packed_mac_numpy(ctq.astype(np.int64), pad_idx,
                                   jn._galois_bfv["k"]))
    np.testing.assert_array_equal(twin, np.stack([[c.c0, c.c1] for c in pt]))
    got = tc.decrypt_scores_packed([c.to_wire() for c in pt], nt, q, gt)
    np.testing.assert_array_equal(got, _exact(base, cand, q))


@pytest.mark.parametrize("entry", ["host", "seedTf"])
def test_program_at_the_operating_point(op_point, entry):
    """N=4096, d=128, P=256, nq=1: both entries bit-equal to the JAX numpy
    oracle and the JAX jitted program; K2 50 (host-expanded) or 52 (seedTf)
    transforms; the decrypted distances equal the float64 distances."""
    tc, jc, ts, jn, js, base, _ = op_point
    q, cand = _queries(7, 1, 128, 256)
    wires = tc.encrypt_query_batch(q)
    assert all("seedTf" in w for w in wires)
    plain = ntt4_step.ntt4_step_plain.calls
    launches = ntt4_fused.ntt4_transform.launches
    if entry == "host":
        cts = [ts.ctx.ct_from_wire(w) for w in wires]
        pt, nt, gt = ts.encrypted_scores_packed(cts, cand, "k")
        jcts = [jn.ctx.ct_from_wire(w) for w in wires]
        pj, nj, gj = js.encrypted_scores_packed(jcts, cand, "k")
        po, _, _ = jn.encrypted_scores_packed(jcts, cand, "k")
        transforms = 2 * 2 + 7 * 2 * 3 + 2 * 2
    else:
        pt, nt, gt = ts.encrypted_scores_packed_wire(wires, cand, "k")
        pj, nj, gj = js.encrypted_scores_packed_wire(wires, cand, "k")
        po, _, _ = jn.encrypted_scores_packed_wire(wires, cand, "k")
        transforms = 2 + 2 * 2 + 7 * 2 * 3 + 2 * 2
    assert transforms == {"host": 50, "seedTf": 52}[entry]
    assert ntt4_step.ntt4_step_plain.calls - plain == 2 * transforms
    assert ntt4_fused.ntt4_transform.launches == launches
    assert gt == gj == 16 and len(pt) == 1
    assert pt[0].c0.shape == (2, 4096) and not pt[0].is_ntt
    _assert_same_cts(pt, pj, po)
    np.testing.assert_array_equal(nt, nj)
    got = tc.decrypt_scores_packed([c.to_wire() for c in pt], nt, q, gt)
    np.testing.assert_array_equal(got.astype(np.float64),
                                  _exact(base, cand, q))
    # each package's client decrypts the other's server's answer
    np.testing.assert_array_equal(
        jc.decrypt_scores_packed([c.to_wire() for c in pt], nt, q, gt),
        tc.decrypt_scores_packed([c.to_wire() for c in pj], nj, q, gj))


def test_refusals_match_jax(small):
    """A wrong keyId, a key whose digitBits disagrees with its shape, a key
    set missing an extraction element, another basis, no base: refused as
    the JAX service refuses (ValueError, or RuntimeError where JAX
    asserts)."""
    tc, jc, ts, jn, js, base, gks = small
    q, cand = _queries(3, 2, 32, 64)
    cts = [ts.ctx.ct_from_wire(w) for w in tc.encrypt_query_batch(q)]
    assert ts.has_galois_keys("k") and not ts.has_galois_keys("nope")
    for svc in (ts, jn):
        with pytest.raises(ValueError, match="keyId"):
            svc.encrypted_scores_packed(cts, cand, "nope")
        with pytest.raises(ValueError, match="keyId"):
            svc.encrypted_scores_packed_wire(
                tc.encrypt_query_batch(q), cand, "nope")
        bad = {g: dict(w, digitBits=15) for g, w in gks.items()}
        with pytest.raises(ValueError, match="digitBits"):
            svc.register_galois_keys("bad", bad)
        assert not svc.has_galois_keys("bad")
        first = min(gks, key=int)
        svc.register_galois_keys("short", {
            g: w for g, w in gks.items() if g != first})
        with pytest.raises(ValueError, match=f"element {first}"):
            svc.encrypted_scores_packed(cts, cand, "short")
    other = dict(gks[first], ext=[1, 2, 3])
    with pytest.raises(ValueError, match="basis"):
        ts.register_galois_keys("other", {first: other})
    fresh = TService(tc.params, device="cpu")
    fresh.register_galois_keys("k", gks)
    with pytest.raises(RuntimeError, match="set_base"):
        fresh.encrypted_scores_packed(cts, cand, "k")
