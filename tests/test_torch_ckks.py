"""Port parity: the CKKS host arithmetic (crypto/ckks.py) against the JAX
package's, at the fixture of tests/test_crypto_ckks.py (N=512, scale 2^26,
3 limbs).

Both sides draw from numpy generators with the same seed, so keys,
ciphertexts and wires must be equal integer for integer (tolerance zero);
decoded slot values are float64 from the same FFT, equal to the last bit.
Wires cross both ways: what one package writes, the other parses and writes
again unchanged."""

import os

import numpy as np
import pytest

from prefhetch_tpu.crypto import ckks as J
from prefhetch_tpu.crypto.params import CKKSParams as JParams
from prefhetch_tpu_torch.crypto import ckks as T
from prefhetch_tpu_torch.crypto.params import CKKSParams as TParams
from prefhetch_tpu_torch.crypto.params import find_ntt_primes

N = 512
KAT_DIR = os.path.join(os.path.dirname(__file__), "kat")


@pytest.fixture(scope="module")
def ctxs():
    qs = tuple(find_ntt_primes(N, 30, 3))
    return (J.CKKSContext(JParams(n=N, scale_bits=26, qs=qs)),
            T.CKKSContext(TParams(n=N, scale_bits=26, qs=qs)))


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.fixture(scope="module")
def keys(ctxs):
    jc, tc = ctxs
    rj, rt = _rngs(1)
    return jc.keygen(rj), tc.keygen(rt)


def _same_ct(a, b):
    assert a.level == b.level and a.scale == b.scale
    np.testing.assert_array_equal(a.c0, b.c0)
    np.testing.assert_array_equal(a.c1, b.c1)


def test_context_and_keygen_bit_equal(ctxs, keys):
    jc, tc = ctxs
    (jsk, jpk), (tsk, tpk) = keys
    assert tc.ext == jc.ext and tc.p == jc.p and tc.scale == jc.scale
    np.testing.assert_array_equal(tc.rot_group, jc.rot_group)
    np.testing.assert_array_equal(tsk.s_small, jsk.s_small)
    np.testing.assert_array_equal(tsk.s_rns, jsk.s_rns)
    np.testing.assert_array_equal(tpk.b_rns, jpk.b_rns)
    np.testing.assert_array_equal(tpk.a_rns, jpk.a_rns)


@pytest.mark.parametrize("batched,scale", [(False, None), (True, None),
                                           (False, 2.0 ** 29)])
def test_encode_and_decode_bit_equal(ctxs, batched, scale):
    jc, tc = ctxs
    rng = np.random.default_rng(2)
    shape = (5, N // 2) if batched else (N // 3,)    # short vectors pad
    v = rng.normal(size=shape) * 50
    cj, ct = jc.encode(v, scale=scale), tc.encode(v, scale=scale)
    assert ct.dtype == np.int64
    np.testing.assert_array_equal(ct, cj)
    rows = ct if batched else ct[None]
    for r in rows:
        np.testing.assert_array_equal(
            tc.decode(r, scale or tc.scale), jc.decode(r, scale or jc.scale))


def test_encode_matrix_real_bit_equal(ctxs):
    jc, tc = ctxs
    m = tc.encode_matrix_real()
    assert m.dtype == np.float32 and m.shape == (N // 2, N)
    np.testing.assert_array_equal(m, jc.encode_matrix_real())
    # its linear form is the encode at f64, as the JAX test holds it
    z = np.random.default_rng(11).normal(size=(4, N // 2)) * 4e-3
    np.testing.assert_array_equal(
        np.round((z @ m.astype(np.float64)) * tc.scale).astype(np.int64),
        tc.encode(z))


@pytest.mark.parametrize("form", ["public", "seedTf"])
def test_encrypt_wires_bit_equal_and_cross_parse(ctxs, keys, form):
    """encrypt / encrypt_symmetric_tf with the same rng give the same wire;
    ct_from_wire of either package's wire gives the same ciphertext, and
    a parsed wire written again is the dict it came from."""
    jc, tc = ctxs
    (jsk, jpk), (tsk, tpk) = keys
    rj, rt = _rngs(3)
    coeffs = tc.encode(np.random.default_rng(4).normal(size=N // 2) * 20)
    if form == "public":
        wj = jc.encrypt(jpk, coeffs, rj).to_wire()
        wt = tc.encrypt(tpk, coeffs, rt).to_wire()
    else:
        wj = jc.encrypt_symmetric_tf(jsk, coeffs, rj)
        wt = tc.encrypt_symmetric_tf(tsk, coeffs, rt)
        assert set(wt) == {"c0", "seedTf", "shape", "level", "scale"}
    assert wt == wj
    ct_t, ct_j = tc.ct_from_wire(wj), jc.ct_from_wire(wt)
    _same_ct(ct_t, ct_j)
    w2 = ct_t.to_wire()
    assert T.CKKSCiphertext.from_wire(w2).to_wire() == w2
    assert J.CKKSCiphertext.from_wire(w2).to_wire() == w2
    np.testing.assert_array_equal(tc.decrypt(tsk, ct_t),
                                  jc.decrypt(jsk, ct_j))
    np.testing.assert_array_equal(tc.decrypt_coeffs(tsk, ct_t),
                                  jc.decrypt_coeffs(jsk, ct_j))


def test_add_mul_plain_rescale_bit_equal(ctxs, keys):
    jc, tc = ctxs
    (_, jpk), _ = keys
    rng = np.random.default_rng(5)
    a, b = (tc.encode(rng.normal(size=N // 2) * 5) for _ in range(2))
    ca = jc.encrypt(jpk, a, rng)
    cb = jc.encrypt(jpk, b, rng)
    ta, tb = (T.CKKSCiphertext.from_wire(c.to_wire()) for c in (ca, cb))
    _same_ct(tc.add(ta, tb), jc.add(ca, cb))
    pt = tc.encode(rng.normal(size=N // 2) * 5)
    _same_ct(tc.mul_plain(ta, pt, tc.scale), jc.mul_plain(ca, pt, jc.scale))
    _same_ct(tc.rescale(ta), jc.rescale(ca))


@pytest.mark.parametrize("digit_bits", [15, 30])
def test_galois_keys_and_rotate_bit_equal(ctxs, keys, monkeypatch,
                                          digit_bits):
    """galois_keygen wires (the JAX package takes the width from its
    module constant, the port from the argument), rotate, and the combine
    tree's negative steps; keys parsed across packages rotate alike."""
    jc, tc = ctxs
    (jsk, jpk), (tsk, _) = keys
    steps = [1, 4, -2, -8]
    rj, rt = _rngs(6)
    monkeypatch.setattr(J, "DIGIT_BITS", digit_bits)
    gj = jc.galois_keygen(jsk, steps, rj)
    monkeypatch.undo()
    gt = tc.galois_keygen(tsk, steps, rt, digit_bits=digit_bits)
    assert T.DIGIT_BITS == 15
    for s in steps:
        wt = gt[s].to_wire()
        assert wt == gj[s].to_wire() and wt["digitBits"] == digit_bits
        assert T.GaloisKey.from_wire(gj[s].to_wire()).to_wire() == wt
        assert J.GaloisKey.from_wire(wt).to_wire() == wt
    v = np.random.default_rng(7).normal(size=N // 2) * 10
    ct = jc.encrypt(jpk, tc.encode(v), np.random.default_rng(8))
    tct = T.CKKSCiphertext.from_wire(ct.to_wire())
    for s in steps:
        got = tc.rotate(tct, s, T.GaloisKey.from_wire(gj[s].to_wire()))
        _same_ct(got, jc.rotate(ct, s, gj[s]))
        np.testing.assert_allclose(np.real(tc.decrypt(tsk, got)),
                                   np.roll(v, -s), atol=0.05)


def test_mul_relinearize_bit_equal(ctxs, keys):
    jc, tc = ctxs
    (jsk, jpk), (tsk, _) = keys
    rj, rt = _rngs(9)
    rk_j = jc.relin_keygen(jsk, rj)
    rk_t = tc.relin_keygen(tsk, rt)
    assert rk_t.to_wire() == rk_j.to_wire() and rk_t.step == -1
    rng = np.random.default_rng(10)
    a, b = (rng.normal(size=N // 2) * 3 for _ in range(2))
    ca = jc.encrypt(jpk, tc.encode(a), rng)
    cb = jc.encrypt(jpk, tc.encode(b), rng)
    ta, tb = (T.CKKSCiphertext.from_wire(c.to_wire()) for c in (ca, cb))
    got = tc.mul(ta, tb, rk_t)
    _same_ct(got, jc.mul(ca, cb, rk_j))
    np.testing.assert_allclose(np.real(tc.decrypt(tsk, got)), a * b,
                               atol=0.05)


@pytest.mark.parametrize("p,d", [(10, 32), (60, 32), (256, 128), (7, 64),
                                 (1, 16)])
def test_combined_layout_helpers_equal(ctxs, p, d):
    jc, tc = ctxs
    slots = N // 2
    assert T.combined_blocks_padded(p, slots, d) == \
        J.combined_blocks_padded(p, slots, d)
    nb = T.combined_blocks_padded(p, slots, d)
    if nb <= d:
        assert T.combine_window(d, nb) == J.combine_window(d, nb)
        assert tc.combine_tree_steps(nb, d) == jc.combine_tree_steps(nb, d)
    vals = np.random.default_rng(p).normal(size=slots) \
        + 1j * np.random.default_rng(d).normal(size=slots)
    if p <= slots // d * d and nb <= d:
        got = T.extract_combined_ips(vals, p, d)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, J.extract_combined_ips(vals, p, d))


def test_ckks_kat_decrypts_with_the_port():
    """The textbook-built CKKS ciphertext of tests/kat/ckks_kat.npz (an
    independent big-int implementation) decrypts with the port."""
    from prefhetch_tpu_torch.crypto.params import ckks_params_for

    with np.load(os.path.join(KAT_DIR, "ckks_kat.npz")) as z:
        kat = {k: z[k] for k in z.files}
    params = ckks_params_for(int(kat["n"]), int(kat["scale_bits"]), 2)
    assert tuple(int(q) for q in kat["qs"]) == tuple(params.qs)
    ctx = T.CKKSContext(params)
    s_small = kat["s"].astype(np.int64)
    sk = T.CKKSSecretKey(s_rns=ctx._to_rns(s_small), s_small=s_small)
    ct = T.CKKSCiphertext(
        c0=kat["c0"], c1=kat["c1"], level=len(params.qs),
        scale=float(1 << int(kat["scale_bits"])),
    )
    got = np.real(ctx.decrypt(sk, ct))
    np.testing.assert_allclose(got, kat["values"], atol=2e-3)
