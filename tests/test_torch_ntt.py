"""Port parity: the four-step NTT (ops/ntt4.py) and the plain stage of its
kernel K2 (ops/ntt4_step.py) against the JAX package.

Everything here is integer arithmetic mod q: tolerance zero. The JAX side
runs its Pallas kernel in interpret mode (the same kernel program the TPU
runs) and its XLA formulation; the port runs on CPU tensors, where K2's
wrapper takes the plain version. Between stages the two implementations may
leave different lazy values (the Pallas kernel up to 2q, the plain version
always below q): residues must agree, ranges need not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prefhetch_tpu.crypto import ntt as j_hostntt
from prefhetch_tpu.crypto import params as j_params
from prefhetch_tpu.ops import ntt_mxu as j_mxu
from prefhetch_tpu.ops import ntt_pallas as j_pallas
from prefhetch_tpu_torch.crypto import ntt as t_hostntt
from prefhetch_tpu_torch.crypto import params as t_params
from prefhetch_tpu_torch.ops import ntt4 as t_ntt4
from prefhetch_tpu_torch.ops import ntt4_step as t_step

torch.set_num_threads(1)


def _recompose(digits: np.ndarray) -> np.ndarray:
    """[4, m, m] balanced base-256 int8 digits → the integer matrix."""
    return sum(digits[i].astype(np.int64) << (8 * i) for i in range(4))


@pytest.mark.parametrize("n", [256, 4096, 8192])
def test_primes_roots_and_tables_identical(n):
    qs = t_params.find_ntt_primes(n, 30, 3)
    assert qs == j_params.find_ntt_primes(n, 30, 3)
    q = qs[0]
    assert t_params.root_of_unity(q, 2 * n) == j_params.root_of_unity(q, 2 * n)
    jt = j_mxu.build_ntt4_tables(q, n)
    tt = t_ntt4.build_ntt4_tables(q, n)
    assert (tt.q, tt.n, tt.n1, tt.n2) == (jt.q, jt.n, jt.n1, jt.n2)
    # the port keeps each matrix in right-multiply form: W = M.T
    for name_t, name_j in (("f_a", "f_w1"), ("f_b", "f_w2"), ("g_a", "g_w2"),
                           ("g_b", "g_w1")):
        w = getattr(tt, name_t).w
        assert w.min() >= 0 and w.max() < q
        np.testing.assert_array_equal(w.T, _recompose(getattr(jt, name_j)),
                                      err_msg=name_t)
    # stage f_a works on the transposed block [k2, j1], stage g_a on [j1, k2]
    np.testing.assert_array_equal(tt.f_a.tw.T, jt.f_tw)
    np.testing.assert_array_equal(tt.g_a.tw, jt.g_tw)
    assert tt.f_b.tw is None and tt.g_b.tw is None
    # the host butterfly tables too
    jh, th = j_hostntt.build_tables(q, n), t_hostntt.build_tables(q, n)
    np.testing.assert_array_equal(th.psi_pows, jh.psi_pows)
    np.testing.assert_array_equal(th.ipsi_pows, jh.ipsi_pows)
    np.testing.assert_array_equal(th.bitrev, jh.bitrev)


def test_step_tables_match_pallas_packing():
    """The port's right-multiply W, twiddles and Shoup companions are the
    integers the Pallas kernel is fed (its block-diagonal packing undone)."""
    n = 8192
    q = t_params.find_ntt_primes(n, 30, 1)[0]
    tt = t_ntt4.build_ntt4_tables(q, n)
    pt = j_pallas.build_pallas_ntt4(q, n)
    for name in ("f_a", "f_b", "g_a", "g_b"):
        ts, ps = getattr(tt, name), getattr(pt, name)
        assert (ts.r, ts.m) == (ps.r, ps.m), name
        np.testing.assert_array_equal(
            ts.w, _recompose(ps.wd[:, :ts.m, :ts.m]), err_msg=name)
        if ps.tw is None:
            assert ts.tw is None and ts.tw_shoup is None
        else:
            np.testing.assert_array_equal(
                ts.tw.astype(np.uint32), ps.tw.reshape(ts.r, ts.m))
            np.testing.assert_array_equal(
                ts.tw_shoup, ps.tw_shoup.reshape(ts.r, ts.m))


@pytest.mark.parametrize("name", ["f_a", "f_b", "g_a", "g_b"])
def test_step_plain_matches_pallas_step(name):
    """One stage, m = 64 and 128, with and without twiddle (N = 8192 has all
    four), on lazy inputs anywhere in [0, 2^31)."""
    n = 8192
    q = t_params.find_ntt_primes(n, 30, 1)[0]
    tt = t_ntt4.build_ntt4_tables(q, n)
    pt = j_pallas.build_pallas_ntt4(q, n)
    ts, ps = getattr(tt, name), getattr(pt, name)
    rng = np.random.default_rng(ts.m + ts.r + (ts.tw is None))
    x = rng.integers(0, 1 << 31, (3, ts.r, ts.m), dtype=np.int64)
    x[0, 0, :4] = [0, q - 1, q, (1 << 31) - 1]
    x = x.astype(np.int32)
    canonical = ts.tw is None
    want = np.asarray(j_pallas._run_step(
        jnp.asarray(x), ps, q, pt.delta, canonical, True))
    calls = t_step.ntt4_step_plain.calls
    got = t_step.ntt4_step_plain(torch.from_numpy(x), ts).numpy()
    assert t_step.ntt4_step_plain.calls == calls + 1
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < q
    assert want.min() >= 0                      # lazy, but below 2^31
    np.testing.assert_array_equal(got, want.astype(np.int64) % q)
    # and against the definition, in Python integers, on one row
    row = [int(v) for v in x[1, 2]]
    ref = [sum(row[k] * int(ts.w[k, j]) for k in range(ts.m)) % q
           for j in range(ts.m)]
    if ts.tw is not None:
        ref = [ref[j] * int(ts.tw[2, j]) % q for j in range(ts.m)]
    assert got[1, 2].tolist() == ref


def _xla_ntt4(x, tb):
    """The JAX package's XLA path, bypassing its TPU dispatch."""
    q, delta = tb.q, tb.delta
    b = x.shape[0]
    a = x.reshape(b, tb.n1, tb.n2)
    y = j_mxu._small_matmul_mod(a, jnp.asarray(tb.f_w1), q, delta, axis=1)
    c = j_mxu.modmul(y, jnp.asarray(tb.f_tw)[None], q, delta)
    d = j_mxu._small_matmul_mod(c, jnp.asarray(tb.f_w2), q, delta, axis=2)
    return d.reshape(b, tb.n)


def _xla_intt4(x, tb):
    q, delta = tb.q, tb.delta
    b = x.shape[0]
    a = x.reshape(b, tb.n1, tb.n2)
    y = j_mxu._small_matmul_mod(a, jnp.asarray(tb.g_w2), q, delta, axis=2)
    c = j_mxu.modmul(y, jnp.asarray(tb.g_tw)[None], q, delta)
    d = j_mxu._small_matmul_mod(c, jnp.asarray(tb.g_w1), q, delta, axis=1)
    return d.reshape(b, tb.n)


@pytest.mark.parametrize("n,bsz", [(4096, 5), (4096, 33), (8192, 3)])
def test_ntt4_matches_pallas_xla_and_host_butterfly(n, bsz):
    """Forward transform on lazy-range inputs in [0, 2q−1), odd batches:
    equal to the interpreted Pallas kernel, to the XLA path and, after the
    four-step permutation, to the host butterfly."""
    q = t_params.find_ntt_primes(n, 30, 1)[0]
    jt = j_mxu.build_ntt4_tables(q, n)
    pt = j_pallas.build_pallas_ntt4(q, n)
    tt = t_ntt4.build_ntt4_tables(q, n)
    rng = np.random.default_rng(7 + n + bsz)
    x = rng.integers(0, 2 * q - 1, (bsz, n), dtype=np.int64)
    got = t_ntt4.ntt4(torch.from_numpy(x), tt)
    assert got.dtype == torch.int32
    got = got.numpy()
    assert got.min() >= 0 and got.max() < q
    np.testing.assert_array_equal(
        got, np.asarray(j_pallas.ntt4_pallas(jnp.asarray(x), pt,
                                             interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(_xla_ntt4(jnp.asarray(x % q), jt)) % q)
    perm, inv_perm = t_ntt4.fourstep_perm(tt)
    host = t_hostntt.ntt(x % q, t_hostntt.build_tables(q, n))
    np.testing.assert_array_equal(got, host[:, perm])
    np.testing.assert_array_equal(got[:, inv_perm], host)


@pytest.mark.parametrize("n,bsz", [(4096, 5), (8192, 3)])
def test_intt4_matches_pallas_xla_and_roundtrips(n, bsz):
    q = t_params.find_ntt_primes(n, 30, 1)[0]
    jt = j_mxu.build_ntt4_tables(q, n)
    pt = j_pallas.build_pallas_ntt4(q, n)
    tt = t_ntt4.build_ntt4_tables(q, n)
    rng = np.random.default_rng(11 + n)
    x = rng.integers(0, 2 * q - 1, (bsz, n), dtype=np.int64)
    got = t_ntt4.intt4(torch.from_numpy(x), tt).numpy()
    assert got.min() >= 0 and got.max() < q
    np.testing.assert_array_equal(
        got, np.asarray(j_pallas.intt4_pallas(jnp.asarray(x), pt,
                                              interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(_xla_intt4(jnp.asarray(x % q), jt)) % q)
    # four-step order in → natural order out: the host butterfly's inverse
    # of the un-permuted input
    _, inv_perm = t_ntt4.fourstep_perm(tt)
    host = t_hostntt.intt((x % q)[:, inv_perm], t_hostntt.build_tables(q, n))
    np.testing.assert_array_equal(got, host)
    # forward ∘ inverse = identity, and across the packages
    back = t_ntt4.ntt4(torch.from_numpy(got), tt).numpy()
    np.testing.assert_array_equal(back, x % q)
    back_j = np.asarray(j_pallas.ntt4_pallas(jnp.asarray(got), pt,
                                             interpret=True))
    np.testing.assert_array_equal(back_j, x % q)


def test_small_ring_transform_matches_xla():
    """N = 256 (16 × 16: the size of the service tests) has no Pallas form
    in the JAX package; the XLA path and the host butterfly are the
    reference. Pointwise products in four-step order are negacyclic
    convolutions."""
    n = 256
    q = t_params.find_ntt_primes(n, 30, 2)[1]
    jt = j_mxu.build_ntt4_tables(q, n)
    tt = t_ntt4.build_ntt4_tables(q, n)
    rng = np.random.default_rng(5)
    a = rng.integers(0, q, (2, n), dtype=np.int64)
    fa = t_ntt4.ntt4(torch.from_numpy(a), tt)
    np.testing.assert_array_equal(
        fa.numpy(), np.asarray(_xla_ntt4(jnp.asarray(a), jt)))
    prod = t_ntt4.modmul(fa[0:1], fa[1:2], q)
    assert prod.dtype == torch.int64
    np.testing.assert_array_equal(
        prod.numpy(),
        np.asarray(j_mxu.modmul(jnp.asarray(fa[0:1].numpy()),
                                jnp.asarray(fa[1:2].numpy()), q, jt.delta)))
    conv = t_ntt4.intt4(prod, tt).numpy()[0]
    np.testing.assert_array_equal(
        conv, t_hostntt.naive_negacyclic_polymul(a[0], a[1], q))


def test_host_butterfly_identical():
    n = 4096
    q = t_params.find_ntt_primes(n, 30, 2)[1]
    x = np.random.default_rng(2).integers(0, q, (3, n), dtype=np.int64)
    jh, th = j_hostntt.build_tables(q, n), t_hostntt.build_tables(q, n)
    f = t_hostntt.ntt(x, th)
    np.testing.assert_array_equal(f, np.asarray(j_hostntt.ntt(x, jh)))
    np.testing.assert_array_equal(t_hostntt.intt(f, th), x)
    np.testing.assert_array_equal(
        t_hostntt.intt(x, th), np.asarray(j_hostntt.intt(x, jh)))
