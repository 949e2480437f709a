"""Port parity: the host crypto copies (crypto/, client/he.py, utils/wire.py)
against the JAX package. All integer: tolerance zero. ``secure_rng(seed)``
with an integer seed is deterministic, so the same seed must give the same
keys and the same wires in both packages, and each package must decrypt what
the other encrypted or computed."""

import numpy as np
import pytest

from prefhetch_tpu.client.he import HEClient as JClient
from prefhetch_tpu.crypto import bfv as j_bfv
from prefhetch_tpu.crypto import packing as j_packing
from prefhetch_tpu.crypto import params as j_params
from prefhetch_tpu.crypto import rng as j_rng
from prefhetch_tpu.engine.hecompute import HEComputeService as JService
from prefhetch_tpu.utils import wire as j_wire
from prefhetch_tpu.utils.config import HEParams as JHEParams
from prefhetch_tpu_torch.client.he import HEClient as TClient
from prefhetch_tpu_torch.crypto import bfv as t_bfv
from prefhetch_tpu_torch.crypto import packing as t_packing
from prefhetch_tpu_torch.crypto import params as t_params
from prefhetch_tpu_torch.crypto import rng as t_rng
from prefhetch_tpu_torch.engine.hecompute import HEComputeService as TService
from prefhetch_tpu_torch.utils import wire as t_wire
from prefhetch_tpu_torch.utils.config import HEParams as THEParams

D, N = 32, 256


def _clients(seed, **kw):
    return (JClient(JHEParams(n=N, **kw), seed=seed),
            TClient(THEParams(n=N, **kw), seed=seed))


def _data(seed=0, nbase=300, nq=3, p=20):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (nbase, D)).astype(np.float32)
    q = rng.integers(0, 256, (nq, D)).astype(np.float32)
    cand = rng.integers(0, nbase, (nq, p))
    exact = ((base[cand] - q[:, None]) ** 2).sum(-1)
    return base, q, cand, exact


@pytest.mark.parametrize("kw", [
    dict(n=4096, t_bits=24, n_limbs=2), dict(n=256, t_bits=24, n_limbs=3),
    dict(n=8192, t_bits=20, n_limbs=2, odd_t=True),
])
def test_params_identical(kw):
    a, b = j_params.bfv_params_for(**kw), t_params.bfv_params_for(**kw)
    assert (a.n, a.t, a.qs, a.q, a.delta, a.delta_rns()) == \
        (b.n, b.t, b.qs, b.q, b.delta, b.delta_rns())


def test_secure_rng_same_key_same_stream():
    a, b = j_rng.SecureRNG(b"k" * 48), t_rng.SecureRNG(b"k" * 48)
    for lo, hi, size in ((-1, 2, (5, 7)), (0, 1 << 62, 9), (3, 1000, 40)):
        np.testing.assert_array_equal(a.integers(lo, hi, size=size),
                                      b.integers(lo, hi, size=size))
    np.testing.assert_array_equal(a.binomial_half(21, (4, 6)),
                                  b.binomial_half(21, (4, 6)))
    assert isinstance(t_rng.secure_rng(None), t_rng.SecureRNG)
    assert t_rng.secure_rng(5).integers(0, 100) == \
        j_rng.secure_rng(5).integers(0, 100)


def test_packing_and_wire_identical():
    rng = np.random.default_rng(4)
    p_j = j_params.bfv_params_for(N, 24, 2)
    p_t = t_params.bfv_params_for(N, 24, 2)
    x = rng.integers(-50, 256, (11, D)).astype(np.float32)
    np.testing.assert_array_equal(t_packing.encode_query_poly(x[0], p_t),
                                  j_packing.encode_query_poly(x[0], p_j))
    a, ba = t_packing.pack_candidates(x, p_t)
    b, bb = j_packing.pack_candidates(x, p_j)
    assert ba == bb == N // D
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="integer-valued"):
        t_packing.encode_query_poly(x[0] + 0.5, p_t)
    arr = rng.integers(-2**31, 2**31, (3, 4, 5)).astype(np.int32)
    assert t_wire.pack_i32(arr) == j_wire.pack_i32(arr)
    np.testing.assert_array_equal(t_wire.unpack_i32(j_wire.pack_i32(arr)),
                                  arr)
    with pytest.raises(ValueError, match="declared shape"):
        t_wire.unpack_i32({"b64": t_wire.pack_i32(arr)["b64"],
                           "shape": [7]})


@pytest.mark.parametrize("kw", [dict(), dict(sparse_h=32),
                                dict(n_limbs=3)])
def test_same_seed_same_keys_and_wires(kw):
    jc, tc = _clients(21, **kw)
    np.testing.assert_array_equal(tc.sk.s_rns, jc.sk.s_rns)
    np.testing.assert_array_equal(tc.pk.b_rns, jc.pk.b_rns)
    np.testing.assert_array_equal(tc.pk.a_rns, jc.pk.a_rns)
    if kw.get("sparse_h"):
        s = tc.sk.s_rns[0]
        assert int(((s == 1) | (s == tc.params.qs[0] - 1)).sum()) == 32
    _, q, _, _ = _data()
    wj, wt = jc.encrypt_query_batch(q), tc.encrypt_query_batch(q)
    assert wt == wj                      # seeded symmetric wires, all fields
    assert set(wt[0]) == {"c0", "seed", "shape", "isNtt", "scheme"}
    assert tc.encrypt_query(q[0]) == jc.encrypt_query(q[0])   # public-key


def test_wire_expansion_and_cross_decrypt():
    """ct_from_wire expands the seeded c1 identically; each package decrypts
    the other's ciphertexts to the encoded query."""
    jc, tc = _clients(8)
    _, q, _, _ = _data()
    wires = tc.encrypt_query_batch(q)
    for w, row in zip(wires, q):
        ct_t = tc.ctx.ct_from_wire(w)
        ct_j = jc.ctx.ct_from_wire(w)
        assert ct_t.is_ntt and ct_j.is_ntt
        np.testing.assert_array_equal(ct_t.c0, ct_j.c0)
        np.testing.assert_array_equal(ct_t.c1, ct_j.c1)
        want = t_packing.encode_query_poly(row, tc.params)
        np.testing.assert_array_equal(tc.ctx.decrypt(tc.sk, ct_j), want)
        np.testing.assert_array_equal(
            jc.ctx.decrypt(jc.sk, j_bfv.Ciphertext(ct_t.c0, ct_t.c1, True)),
            want)
    # public-key ciphertexts through the plain wire form
    w = jc.encrypt_query(q[1])
    ct = t_bfv.Ciphertext.from_wire(w)
    assert ct.to_wire() == {k: v for k, v in w.items() if k != "scheme"}
    np.testing.assert_array_equal(
        tc.ctx.decrypt_batch(tc.sk, [ct])[0],
        t_packing.encode_query_poly(q[1], tc.params))
    v = np.stack([ct.c0[0], ct.c1[0]])[:, :5]
    assert tc.ctx._crt_compose(
        np.concatenate([v, np.zeros((2, N - 5), np.int64)], 1)
    )[:5] == jc.ctx._crt_compose(
        np.concatenate([v, np.zeros((2, N - 5), np.int64)], 1))[:5]
    # threefry-seeded wires (the packed client's): the same wires from one
    # seed, expanded to the same ciphertext, decrypting to the query
    pj, pt = _clients(8, resp_mod="packed")
    tf_wires = pt.encrypt_query_batch(q)
    assert tf_wires == pj.encrypt_query_batch(q)
    assert set(tf_wires[0]) == {"c0", "seedTf", "shape", "isNtt", "scheme"}
    for w, row in zip(tf_wires, q):
        ct_t, ct_j = pt.ctx.ct_from_wire(w), pj.ctx.ct_from_wire(w)
        assert ct_t.is_ntt and ct_j.is_ntt
        np.testing.assert_array_equal(ct_t.c0, ct_j.c0)
        np.testing.assert_array_equal(ct_t.c1, ct_j.c1)
        np.testing.assert_array_equal(
            pt.ctx.decrypt(pt.sk, ct_t),
            t_packing.encode_query_poly(row, pt.params))


@pytest.mark.parametrize("mode", ["full", "q1"])
def test_each_client_decrypts_the_other_services_response(mode):
    """JAX service → port client and port service → JAX client: both give
    the exact squared distances (integer data: max |err| 0)."""
    kw = dict(sparse_h=32) if mode == "q1" else {}
    jc, tc = _clients(13, **kw)
    base, q, cand, exact = _data(seed=6)
    wires = tc.encrypt_query_batch(q)
    js = JService(jc.params, backend="numpy")
    js.set_base(base)
    ts = TService(tc.params, device="cpu")
    ts.set_base(base)
    cts_j = [js.ctx.ct_from_wire(w) for w in wires]
    cts_t = [ts.ctx.ct_from_wire(w) for w in wires]
    if mode == "full":
        rj = js.encrypted_scores_trunc(cts_j, cand)
        rt = ts.encrypted_scores_trunc(cts_t, cand)
        dj = jc.decrypt_scores_trunc(*rt, q)
        dt = tc.decrypt_scores_trunc(*rj, q)
    else:
        rj = js.encrypted_scores_trunc_q1(cts_j, cand)
        rt = ts.encrypted_scores_trunc_q1(cts_t, cand)
        dj = jc.decrypt_scores_trunc_q1(*rt, q)
        dt = tc.decrypt_scores_trunc_q1(*rj, q)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a, b)
    assert dt.dtype == dj.dtype == np.float32
    np.testing.assert_array_equal(dt, exact)
    np.testing.assert_array_equal(dj, exact)


def test_client_refuses_what_is_not_ported():
    # an unknown scheme is refused as the JAX client refuses it; CKKS is
    # ported (tests/test_torch_ckks*.py): the JAX client's params and keys
    with pytest.raises(NotImplementedError, match="scheme bgv"):
        TClient(THEParams(scheme="bgv"))
    with pytest.raises(NotImplementedError, match="scheme bgv"):
        JClient(JHEParams(scheme="bgv"))
    he = dict(scheme="ckks", n=256, n_limbs=3)
    jk, tk = JClient(JHEParams(**he), seed=3), TClient(THEParams(**he), seed=3)
    assert (tk.params.n, tk.params.scale_bits, tk.params.qs) == \
        (jk.params.n, jk.params.scale_bits, jk.params.qs)
    np.testing.assert_array_equal(tk.sk.s_rns, jk.sk.s_rns)
    assert tk.bfv_extraction_keys_wire(D) is None
    # the packed response is ported: an odd t, the JAX client's keys, and
    # its Galois keys once
    jc, tc = _clients(2, resp_mod="packed")
    assert (tc.params.n, tc.params.t, tc.params.qs) == \
        (jc.params.n, jc.params.t, jc.params.qs)
    assert tc.params.t == (1 << 24) + 1
    np.testing.assert_array_equal(tc.sk.s_rns, jc.sk.s_rns)
    assert tc.bfv_extraction_keys_wire(D) == jc.bfv_extraction_keys_wire(D)
    assert tc.bfv_extraction_keys_wire(D) is None


# -- the rest of BFVContext: ct×ct, relinearization, Garner, PIR's helpers --

def _ctxs(params_kw):
    jp = j_params.BFVParams(**params_kw)
    tp = t_params.BFVParams(**params_kw)
    return j_bfv.BFVContext(jp), t_bfv.BFVContext(tp)


@pytest.mark.parametrize("case", ["n256_t4096", "n2048_t65536"])
def test_ct_ct_mul_relinearize_matches_jax(case):
    """tests/test_crypto_bfv.py's two ct×ct cases: the same seed gives the
    same relinearization key, the same product ciphertext and the exact
    negacyclic product mod t."""
    n, t, seed, hi = ((256, 1 << 12, 2024, 1 << 12) if case == "n256_t4096"
                      else (2048, 1 << 16, 6, 30))
    kw = dict(n=n, t=t, qs=tuple(t_params.find_ntt_primes(n, 30, 2)))
    jctx, tctx = _ctxs(kw)
    out = []
    for ctx in (jctx, tctx):
        rng = np.random.default_rng(seed)
        sk, pk = ctx.keygen(rng)
        rk = ctx.relin_keygen(sk, rng)
        m1 = rng.integers(0, hi, n).astype(np.int64)
        m2 = rng.integers(0, hi, n).astype(np.int64)
        ct = ctx.mul(ctx.encrypt(pk, m1, rng), ctx.encrypt(pk, m2, rng), rk)
        out.append((rk, ct, ctx.decrypt(sk, ct), m1, m2))
    (jrk, jct, _, _, _), (trk, tct, got, m1, m2) = out
    assert trk.to_wire() == jrk.to_wire()
    np.testing.assert_array_equal(tct.c0, jct.c0)
    np.testing.assert_array_equal(tct.c1, jct.c1)
    full = np.polymul(m1[::-1].astype(object), m2[::-1].astype(object))[::-1]
    ref = np.zeros(n, object)
    for i, c in enumerate(full):
        ref[i % n] += c if i < n else -c
    np.testing.assert_array_equal(
        got, np.array([int(v) % t for v in ref], np.int64))


def test_garner_helpers_match_jax():
    kw = dict(n=256, t=257, qs=tuple(t_params.find_ntt_primes(256, 30, 2)))
    jctx, tctx = _ctxs(kw)
    basis = tctx._ext_basis
    assert basis == jctx._ext_basis
    rng = np.random.default_rng(8)
    x = np.stack([rng.integers(0, q, 256) for q in basis])
    jd = jctx._garner_digits(x, basis)
    np.testing.assert_array_equal(tctx._garner_digits(x, basis), jd)
    for m in (97, basis[0], (1 << 30) - 35):
        np.testing.assert_array_equal(tctx._digits_mod(jd, basis, m),
                                      jctx._digits_mod(jd, basis, m))
    Q = int(np.prod([int(q) for q in basis], dtype=object))
    np.testing.assert_array_equal(tctx._digits_gt(jd, basis, Q // 2),
                                  jctx._digits_gt(jd, basis, Q // 2))
    np.testing.assert_array_equal(tctx._lift_to_basis(x[:2]),
                                  jctx._lift_to_basis(x[:2]))


def test_pir_helpers_match_jax():
    """encrypt_batch(_ntt), add, plain_to_ntt, mul_plain_ntt (the ct×pt
    product decrypts to the negacyclic product mod t) and
    noise_budget_bits, from the same seed, against the JAX package."""
    kw = dict(n=256, t=1 << 24, qs=tuple(t_params.find_ntt_primes(256, 30, 2)))
    jctx, tctx = _ctxs(kw)
    res = []
    for ctx in (jctx, tctx):
        rng = np.random.default_rng(42)
        sk, pk = ctx.keygen(rng)
        ms = rng.integers(0, 256, (3, 256)).astype(np.int64)
        p = np.zeros(256, np.int64)
        p[:16] = rng.integers(0, 256, 16)
        batch = ctx.encrypt_batch(pk, ms, rng)
        batch_ntt = ctx.encrypt_batch_ntt(pk, ms, rng)
        summed = ctx.add(batch[0], batch[1])
        pt = ctx.plain_to_ntt(p)
        prod = ctx.mul_plain_ntt(batch_ntt[2], pt)
        res.append(dict(
            cts=[c.to_wire() for c in batch + batch_ntt + [summed, prod]],
            pt=pt, budget=[ctx.noise_budget_bits(sk, c, m)
                           for c, m in zip(batch, ms)],
            dec_sum=ctx.decrypt(sk, summed), dec_prod=ctx.decrypt(sk, prod),
            ms=ms, p=p))
    j, t = res
    assert t["cts"] == j["cts"] and t["budget"] == j["budget"]
    assert min(t["budget"]) > 15
    np.testing.assert_array_equal(t["pt"], j["pt"])
    np.testing.assert_array_equal(t["dec_sum"], (t["ms"][0] + t["ms"][1])
                                  % (1 << 24))
    full = np.polymul(t["ms"][2][::-1].astype(object),
                      t["p"][::-1].astype(object))[::-1]
    ref = np.zeros(256, object)
    for i, c in enumerate(full):
        ref[i % 256] += c if i < 256 else -c
    np.testing.assert_array_equal(
        t["dec_prod"], np.array([int(v) % (1 << 24) for v in ref], np.int64))
