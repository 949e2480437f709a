"""K2's arithmetic on the CPU: the port's digit split of the NTT tables and a
plain PyTorch emulation of the fused kernel (ops/ntt4_fused.py) against the
JAX package's balanced digits (ops/ntt_mxu.py) and its Pallas NTT stage
(ops/ntt_pallas.py ``_run_step``, in interpret mode).

The kernel itself runs only on the card; ``emulate_step`` and
``emulate_transform`` repeat its integers (fold, int8 digit planes, int32
products by diagonal, the TPU group recombination, the Shoup twiddle), so
these tests hold its arithmetic before any chip run. Everything is integer
arithmetic mod q: tolerance zero, lazy values included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prefhetch_tpu.ops import ntt_mxu as j_mxu
from prefhetch_tpu.ops import ntt_pallas as j_pallas
from prefhetch_tpu_torch.crypto import params as t_params
from prefhetch_tpu_torch.ops import ntt4 as t_ntt4
from prefhetch_tpu_torch.ops import ntt4_fused as nf
from prefhetch_tpu_torch.ops import ntt4_step as t_step

torch.set_num_threads(1)

TABLES = {                    # (direction, fused table) -> ntt_mxu's planes
    ("forward", "t1"): "f_w1", ("forward", "t2"): "f_w2",
    ("inverse", "t1"): "g_w1", ("inverse", "t2"): "g_w2",
}


def _tables(n, limb):
    q = t_params.find_ntt_primes(n, 30, 2)[limb]
    return q, t_ntt4.build_ntt4_tables(q, n)


def _inputs(kind, q, shape, seed):
    """Stage or transform inputs: random residues in [0, q), all q − 1,
    lazy values near 2^31, or int64 residues with high bits set (the kernel
    and ``.to(torch.int32)`` keep the low 32 bits). Transforms also take
    negative values: int32 down to −2^31, and int64 whose low 32 bits are a
    negative int32; then the second tensor holds their residues mod q."""
    rng = np.random.default_rng(seed)
    if kind == "negative int32":
        x = rng.integers(-(1 << 31), 0, shape, dtype=np.int64)
        x.reshape(-1)[:4] = [-1, -q, -(1 << 31), 1 - q]
        return torch.from_numpy(x.astype(np.int32)), (x % q).astype(np.int32)
    if kind == "int64, bit 31 set":
        x = rng.integers(1 << 31, 1 << 32, shape, dtype=np.int64)
        x += rng.integers(-2, 2, shape, dtype=np.int64) << 32
        low = x.astype(np.int32).astype(np.int64)       # what .to(int32) keeps
        return torch.from_numpy(x), (low % q).astype(np.int32)
    if kind == "random":
        x = rng.integers(0, q, shape, dtype=np.int64)
    elif kind == "all q-1":
        x = np.full(shape, q - 1, np.int64)
    elif kind == "near 2^31":
        x = (1 << 31) - 1 - rng.integers(0, 1 << 24, shape, dtype=np.int64)
    else:
        x = rng.integers(0, 1 << 31, shape, dtype=np.int64)
    x.reshape(-1)[:4] = [0, q - 1, q, (1 << 31) - 1]
    if kind == "int64":
        high = rng.integers(0, 4, shape, dtype=np.int64) << 32
        return torch.from_numpy(x + high), x.astype(np.int32)
    return torch.from_numpy(x.astype(np.int32)), x.astype(np.int32)


@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("limb", [0, 1])
@pytest.mark.parametrize("direction,table", sorted(TABLES))
def test_digit_planes_equal_jax_balanced_digits(n, limb, direction, table):
    """The fused kernel's digit planes are ntt_mxu._balanced_digits_int of
    the same matrices, bit for bit, on every stage table."""
    q, tb = _tables(n, limb)
    jt = j_mxu.build_ntt4_tables(q, n)
    ft = nf.fused_tables(tb, direction == "inverse")
    got = getattr(ft, table)
    want = getattr(jt, TABLES[(direction, table)])
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and the port's own copy on a matrix of its own
    m = np.random.default_rng(n + limb).integers(0, q, (7, 9))
    np.testing.assert_array_equal(nf.balanced_digits(m),
                                  j_mxu._balanced_digits_int(m, q))


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_twiddles_and_constants_match_pallas(direction):
    """Stage a's packed twiddles (tw[c], tw[c+1], tws[c], tws[c+1]) and the
    recombination constants are the integers the Pallas kernel uses."""
    n = 8192
    q, tb = _tables(n, 0)
    pt = j_pallas.build_pallas_ntt4(q, n)
    ft = nf.fused_tables(tb, direction == "inverse")
    tw = pt.g_a.tw.reshape(64, n // 64) if direction == "inverse" else \
        pt.f_a.tw.reshape(n // 64, 64).T
    tws = pt.g_a.tw_shoup.reshape(64, n // 64) if direction == "inverse" \
        else pt.f_a.tw_shoup.reshape(n // 64, 64).T
    np.testing.assert_array_equal(ft.tw_packed[..., 0], tw[:, 0::2])
    np.testing.assert_array_equal(ft.tw_packed[..., 1], tw[:, 1::2])
    np.testing.assert_array_equal(ft.tw_packed[..., 2], tws[:, 0::2])
    np.testing.assert_array_equal(ft.tw_packed[..., 3], tws[:, 1::2])
    c = [int(v) for v in nf.recombine_consts(q)]
    assert c[:2] == [q, pt.delta]
    for (w, s), e in zip(((c[2], c[3]), (c[4], c[5]), (c[6], c[7])),
                         (16, 24, 40)):
        assert w == pow(2, e, q) and s == (w << 32) // q
    assert (c[8] + (1 << 31) * (1 + (1 << 16) + (1 << 24) + (1 << 40))) \
        % q == 0


@pytest.mark.parametrize("name", ["f_a", "f_b", "g_a", "g_b"])
@pytest.mark.parametrize("kind", ["random", "all q-1", "near 2^31", "int64"])
def test_emulated_step_matches_pallas_run_step(name, kind):
    """One stage of the kernel's arithmetic (N = 8192: contraction 64 and
    128, with and without twiddle) bit-equal to the Pallas ``_run_step``,
    lazy and canonical, and to ``ntt4_step_plain`` mod q."""
    q, tb = _tables(8192, 1)
    pt = j_pallas.build_pallas_ntt4(q, 8192)
    ts, ps = getattr(tb, name), getattr(pt, name)
    x, x32 = _inputs(kind, q, (2, ts.r, ts.m), seed=ts.m + ts.r + len(kind))
    digits = nf.balanced_digits(ts.w.T)
    want_plain = t_step.ntt4_step_plain(torch.from_numpy(x32), ts).numpy()
    for canonical in (False, True):
        got = nf.emulate_step(x, digits, q, ts.tw, ts.tw_shoup,
                              canonical).numpy()
        want = np.asarray(j_pallas._run_step(
            jnp.asarray(x32), ps, q, pt.delta, canonical, True))
        np.testing.assert_array_equal(got, want.astype(np.int64) & 0xFFFFFFFF)
        assert got.min() >= 0 and got.max() < (q if canonical else 2 * q)
        np.testing.assert_array_equal(got % q, want_plain)


@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["random", "all q-1", "near 2^31", "int64",
                                  "negative int32", "int64, bit 31 set"])
def test_emulated_transform_matches_plain_and_pallas(n, inverse, kind):
    """The whole transform as the kernel runs it (one pass, stage a lazy,
    the transposes folded into the splits, a negative value lifted by 3q)
    equals K2's plain version and the JAX package's two Pallas stages (on
    the same residues: the Pallas kernel takes values in [0, 2^31))."""
    q, tb = _tables(n, 0)
    pt = j_pallas.build_pallas_ntt4(q, n)
    x, x32 = _inputs(kind, q, (3, n), seed=n + inverse + len(kind))
    got = nf.emulate_transform(x, tb, inverse)
    assert got.dtype == torch.int32
    assert torch.equal(got, t_ntt4.transform_plain(x, tb, inverse))
    run = j_pallas.intt4_pallas if inverse else j_pallas.ntt4_pallas
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(run(jnp.asarray(x32), pt, interpret=True)))


@pytest.mark.parametrize("n", [4096, 8192])
def test_int64_input_roundtrips_and_matches_jax(n):
    """ntt4/intt4 on the CPU with int64 input (what ``modmul`` hands the
    inverse) round-trip and equal the JAX package's transforms."""
    q, tb = _tables(n, 1)
    pt = j_pallas.build_pallas_ntt4(q, n)
    x = np.random.default_rng(n).integers(0, q, (3, n), dtype=np.int64)
    fwd = t_ntt4.ntt4(torch.from_numpy(x), tb)
    np.testing.assert_array_equal(
        fwd.numpy(), np.asarray(j_pallas.ntt4_pallas(jnp.asarray(x), pt,
                                                     interpret=True)))
    prod = t_ntt4.modmul(fwd, fwd, q)
    assert prod.dtype == torch.int64
    inv = t_ntt4.intt4(prod, tb)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(j_pallas.intt4_pallas(
            jnp.asarray(prod.numpy()), pt, interpret=True)))
    back = t_ntt4.intt4(fwd.to(torch.int64), tb)
    np.testing.assert_array_equal(back.numpy(), x)
