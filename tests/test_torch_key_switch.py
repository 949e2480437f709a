"""The rotation step's kernels on the CPU (ops/key_switch.py): CPU tensors
take the plain versions, and ``rotate_add`` over them is bit-equal to the
eager int64 rotation step it replaced (copied below as ``_eager_*``), at
int32 and int64 storage, 15- and 30-bit digits, one and two active primes,
N=1,024, uniform residues and every residue q - 1, with x and y one pair
(PIR, packed, CKKS pre and post) and apart (the CKKS tree). The kernels'
arithmetic in Python integers, with the constants the wrapper hands them
and those of ``csrc/key_switch.cu``: the mac's lazy fold cannot wrap its
u64 sums and Barrett gives the canonical sum; the finish's centred
division by the special prime stays below 2^32 and its Shoup multiply is
exact. What the kernels would refuse is refused before any build. The
kernels themselves run in tests/test_torch_cuda.py on the card.

This file imports only torch, numpy and the port."""

import re

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.crypto.params import find_ntt_primes
from prefhetch_tpu_torch.engine.hecompute import Rotations, rotate_add
from prefhetch_tpu_torch.ops import key_switch as ks
from prefhetch_tpu_torch.ops.ntt4 import (
    build_ntt4_tables, intt4, modmul, ntt4,
)
from prefhetch_tpu_torch.utils import cuda_build, stages

N = 1024
PRIMES = find_ntt_primes(N, 30, 3)
U32 = (1 << 32) - 1


def _signed_perm(x, perm, neg, qs):
    y = x[..., perm]
    return torch.where(neg & (y != 0), qs - y, y)


def _eager_key_switch(c1g, kb, ka, tabs, digit_bits):
    """engine/hecompute.py key_switch as it was: int64 digits, products
    and sums, the centred division with int64 %."""
    M, l, n = c1g.shape
    n_digits = -(-30 // digit_bits)
    n_comp = l * n_digits
    dmask = (1 << digit_bits) - 1
    digits = torch.stack(
        [(c1g[:, i] >> (dd * digit_bits)) & dmask
         for i in range(l) for dd in range(n_digits)], dim=1)
    flat = digits.reshape(M * n_comp, n)
    acc0, acc1 = [], []
    for e, tb in enumerate(tabs):
        D = ntt4(flat, tb).reshape(M, n_comp, n)
        s0 = modmul(D, kb[:, e], tb.q).sum(1) % tb.q
        s1 = modmul(D, ka[:, e], tb.q).sum(1) % tb.q
        i01 = intt4(torch.cat([s0, s1]), tb).to(torch.int64)
        acc0.append(i01[:M])
        acc1.append(i01[M:])
    sp = tabs[-1].q
    cp0 = torch.where(acc0[-1] > sp // 2, acc0[-1] - sp, acc0[-1])
    cp1 = torch.where(acc1[-1] > sp // 2, acc1[-1] - sp, acc1[-1])
    out0, out1 = [], []
    for i in range(l):
        q = tabs[i].q
        inv_p = pow(sp, -1, q)
        out0.append((acc0[i] - cp0) % q * inv_p % q)
        out1.append((acc1[i] - cp1) % q * inv_p % q)
    return torch.stack(out0, 1), torch.stack(out1, 1)


def _eager_rotate_add(x0, x1, y0, y1, rot, r, qs):
    """engine/hecompute.py rotate_add as it was."""
    perm, neg = rot.perm[r], rot.neg[r]
    g1 = _signed_perm(y1, perm, neg, qs)
    ks0, ks1 = _eager_key_switch(g1.reshape((-1,) + g1.shape[-2:]),
                                 rot.kb[r], rot.ka[r], rot.tabs,
                                 rot.digit_bits)
    g0 = _signed_perm(y0, perm, neg, qs)
    z0 = ((x0.to(torch.int64) + g0 + ks0.view(x0.shape)) % qs).to(x0.dtype)
    z1 = ((x1.to(torch.int64) + ks1.view(x1.shape)) % qs).to(x1.dtype)
    return z0, z1


def _automorphism(g, n=N):
    """(perm [n] int64, neg [n] bool): out[k] = ±x[perm[k]] for X → X^g."""
    k = np.arange(n)
    kg = (k * g) % (2 * n)
    perm = np.empty(n, np.int64)
    neg = np.empty(n, bool)
    perm[kg % n] = k
    neg[kg % n] = kg >= n
    return torch.from_numpy(perm), torch.from_numpy(neg)


def _residues(rng, shape, qs, fill, dtype):
    """[..., l, N] residues below each limb's modulus: uniform, or every
    one q - 1."""
    q = np.array(qs, np.int64)[:, None]
    if fill == "q-1":
        x = np.broadcast_to(q - 1, shape)
    else:
        x = rng.integers(0, q, shape)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _rotations(rng, l, bits, fill):
    """Two rounds of keys over the first l primes and the special prime
    (the last of PRIMES), NTT-domain residues, and two automorphisms."""
    ext = PRIMES[:l] + PRIMES[-1:]
    tabs = [build_ntt4_tables(q, N) for q in ext]
    n_comp = l * ks.n_digits(bits)
    kb = _residues(rng, (2, n_comp, l + 1, N), ext, fill, torch.int32)
    ka = _residues(rng, (2, n_comp, l + 1, N), ext, "uniform", torch.int32)
    autos = [_automorphism(g) for g in (3, 2 * N - 1)]
    return Rotations(kb, ka, torch.stack([a[0] for a in autos]),
                     torch.stack([a[1] for a in autos]), tabs, bits)


@pytest.mark.parametrize("fill", ["uniform", "q-1"])
@pytest.mark.parametrize("l", [1, 2])
@pytest.mark.parametrize("bits", [15, 30])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rotate_add_over_the_plain_versions_equals_the_eager_step(
        dtype, bits, l, fill):
    rng = np.random.default_rng(bits + 10 * l + (fill == "q-1"))
    rot = _rotations(rng, l, bits, fill)
    qs = torch.tensor(PRIMES[:l], dtype=dtype)[:, None]
    shape = (2, 3, l, N)
    x0, x1, y0, y1 = (_residues(rng, shape, PRIMES[:l], fill, dtype)
                      for _ in range(4))
    calls = [f.calls for f in (ks.ks_digits_plain, ks.ks_mac_plain,
                               ks.ks_finish_plain)]
    launches = [f.launches for f in (ks.ks_digits, ks.ks_mac, ks.ks_finish)]
    for r in range(2):
        for args in ((x0, x1, x0, x1), (x0, x1, y0, y1)):
            got = rotate_add(*args, rot, r)
            want = _eager_rotate_add(*args, rot, r, qs)
            for g, w in zip(got, want):
                assert g.dtype == dtype and g.shape == shape
                assert torch.equal(g, w)
    assert [f.calls for f in (ks.ks_digits_plain, ks.ks_mac_plain,
                              ks.ks_finish_plain)] == [
        calls[0] + 4, calls[1] + 4 * (l + 1), calls[2] + 4]
    assert [f.launches for f in (ks.ks_digits, ks.ks_mac,
                                 ks.ks_finish)] == launches


def test_plain_versions_count_no_launch_while_recording():
    """On the CPU no kernel launches, so ``he.ks.launches`` stays unrecorded
    on the span of a rotation."""
    rng = np.random.default_rng(1)
    rot = _rotations(rng, 2, 15, "uniform")
    x = _residues(rng, (3, 2, N), PRIMES[:2], "uniform", torch.int32)
    stages.clear_spans()
    with stages.record_stages():
        with stages.span("rotation"):
            rotate_add(x, x, x, x, rot, 0)
    assert [c for c in stages.recorded_spans()["counters"]
            if c.name == "he.ks.launches"] == []


def _fold(x, c):
    return (x >> 32) * c + (x & U32)


def _barrett(x, q):
    """The mac's reduction of a u64 sum, with the wrapper's mu."""
    mu = (1 << 64) // q
    r = (x - ((x * mu) >> 64) * q) & ((1 << 64) - 1)
    assert r < 2 * q
    return r - q if r >= q else r


@pytest.mark.parametrize("q", [
    *PRIMES, *find_ntt_primes(8192, 30, 4)[-2:], (1 << 29) + 11, 65537, 3,
])
def test_mac_lazy_fold_cannot_wrap_and_barrett_is_exact(q):
    """The mac's bound: after two folds any u64 is below B2, and B2 plus
    SPAN products of at most (q-1)^2 stays below 2^64. Then its arithmetic
    in Python integers over 40 digit products of q - 1 (and of random
    residues), folded every SPAN, reduced by Barrett, gives the canonical
    sum, every partial below 2^64; Barrett is exact on edge u64 too."""
    span = ks.SPAN
    c = (1 << 32) % q
    b1 = U32 * c + U32                         # fold of any u64
    b2 = (b1 >> 32) * c + U32                  # and again
    assert b2 + span * (q - 1) ** 2 < 1 << 64
    rng = np.random.default_rng(q % 1000)
    for d in ([q - 1] * 40, rng.integers(0, q, 40).tolist()):
        for k in ([q - 1] * 40, rng.integers(0, q, 40).tolist()):
            for n_comp in (2, 4, 6, 14, 15, 40):
                acc, left = 0, span
                for a, b in zip(d[:n_comp], k[:n_comp]):
                    acc += a * b
                    assert acc < 1 << 64
                    left -= 1
                    if left == 0:
                        acc, left = _fold(_fold(acc, c), c), span
                assert _barrett(acc, q) == sum(
                    a * b for a, b in zip(d[:n_comp], k[:n_comp])) % q
    for x in (0, q - 1, q, 2 * q - 1, (q - 1) ** 2, 15 * (q - 1) ** 2,
              (1 << 64) - 1, (1 << 63) + 12345):
        assert _barrett(x, q) == x % q


@pytest.mark.parametrize("qs,p", [
    (PRIMES[:2], PRIMES[2]),                       # p below the limbs
    (PRIMES[1:], PRIMES[0]),                       # p above them
    (find_ntt_primes(8192, 30, 4)[:3], find_ntt_primes(8192, 30, 4)[3]),
    ([65537, 3], (1 << 29) + 11),
])
def test_finish_division_is_exact_below_2_32(qs, p):
    """The finish's centred division by p in u32 arithmetic with the
    constants ``finish_consts`` hands the kernel: t = a + (v > p/2 ? p - v
    : pad - v) lies in [0, 2^32), its Shoup product in [0, 2q), and the
    result is ((a - centred(v)) mod q) · p^-1 mod q; the sums below 3q fit
    u32."""
    consts = ks.finish_consts(qs, p)
    l = len(qs)
    rng = np.random.default_rng(p % 997)
    for i, q in enumerate(qs):
        inv, w, pad = consts[l + i], consts[2 * l + i], consts[3 * l + i]
        assert consts[i] == q and inv * p % q == 1 and pad % q == 0
        assert p <= pad < p + q and 3 * q <= U32
        vs = [0, 1, p // 2, p // 2 + 1, p - 1, *rng.integers(0, p, 20)]
        for a in [0, 1, q - 1, *rng.integers(0, q, 20)]:
            for v in vs:
                a, v = int(a), int(v)
                t = a + (p - v if v > p // 2 else pad - v)
                assert 0 <= t <= U32
                r = (t * inv - ((t * w) >> 32) * q) & U32
                assert r < 2 * q
                r = r - q if r >= q else r
                cv = v - p if v > p // 2 else v
                assert r == (a - cv) % q * inv % q


def test_kernel_source_holds_the_constants_the_wrapper_states():
    src = (cuda_build.CSRC / "key_switch.cu").read_text()
    assert re.search(rf"constexpr int SPAN = {ks.SPAN};", src)
    assert re.search(rf"constexpr int MAX_PRIMES = {ks.MAX_PRIMES};", src)
    assert re.search(rf"constexpr int MAX_N = {ks.MAX_N};", src)
    for name in ("pfh_ks_digits", "pfh_ks_mac", "pfh_ks_finish"):
        assert f'extern "C" int {name}(' in src


def test_refusals_before_any_build():
    rng = np.random.default_rng(2)
    qs = PRIMES[:2]
    y = _residues(rng, (3, 2, N), qs, "uniform", torch.int32)
    perm, neg = _automorphism(3)
    # digits
    with pytest.raises(ValueError, match="int32 or int64"):
        ks.ks_digits(y.to(torch.int16), perm, neg, qs, 15)
    with pytest.raises(ValueError, match=r"contiguous \[M, l, N\]"):
        ks.ks_digits(y.transpose(0, 1), perm, neg, qs, 15)
    with pytest.raises(ValueError, match=r"contiguous \[M, l, N\]"):
        ks.ks_digits(y[0], perm, neg, qs, 15)
    with pytest.raises(ValueError, match="one modulus each"):
        ks.ks_digits(y, perm, neg, qs[:1], 15)
    with pytest.raises(ValueError, match=r"\(1, 2\^30\)"):
        ks.ks_digits(y, perm, neg, [qs[0], 1 << 30], 15)
    with pytest.raises(ValueError, match="perm must be"):
        ks.ks_digits(y, perm.to(torch.int32), neg, qs, 15)
    with pytest.raises(ValueError, match="neg must be"):
        ks.ks_digits(y, perm, neg[:-1], qs, 15)
    with pytest.raises(ValueError, match="digit width"):
        ks.ks_digits(y, perm, neg, qs, 31)
    with pytest.raises(ValueError, match="N up to"):
        big = torch.zeros((1, 1, 2 * ks.MAX_N), dtype=torch.int32)
        ks.ks_digits(big, torch.zeros(2 * ks.MAX_N, dtype=torch.int64),
                     torch.zeros(2 * ks.MAX_N, dtype=torch.bool), qs[:1], 15)
    with pytest.raises(ValueError, match="tensors on"):
        ks.ks_digits(y, perm.to("meta"), neg, qs, 15)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ks.ks_digits(y.to("meta"), perm.to("meta"), neg.to("meta"), qs, 15)
    # mac
    d = _residues(rng, (12, N), [qs[0]], "uniform", torch.int32)
    kb = _residues(rng, (4, 3, N), qs + PRIMES[2:], "uniform", torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ks.ks_mac(d.long(), kb[:, 0], kb[:, 1], qs[0])
    with pytest.raises(ValueError, match="do not match"):
        ks.ks_mac(d[:10], kb[:, 0], kb[:, 1], qs[0])     # 10 rows, 4 digits
    with pytest.raises(ValueError, match="do not match"):
        ks.ks_mac(d, kb[:3, 0], kb[:, 1], qs[0])
    with pytest.raises(ValueError, match="contiguous along N"):
        ks.ks_mac(d, kb[:, 0].t().contiguous().t(), kb[:, 1], qs[0])
    with pytest.raises(ValueError, match="must be contiguous"):
        ks.ks_mac(d.t().contiguous().t(), kb[:, 0], kb[:, 1], qs[0])
    with pytest.raises(ValueError, match=r"\(1, 2\^30\)"):
        ks.ks_mac(d, kb[:, 0], kb[:, 1], 1 << 31)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ks.ks_mac(d.to("meta"), kb[:, 0].to("meta"), kb[:, 1].to("meta"),
                  qs[0])
    # finish
    parts = [_residues(rng, (6, N), [q], "uniform", torch.int32)
             for q in PRIMES]
    with pytest.raises(ValueError, match="does not match x0"):
        ks.ks_finish(parts, y, y.long(), y, perm, neg, qs, PRIMES[2])
    with pytest.raises(ValueError, match="does not match x0"):
        ks.ks_finish(parts, y, y, y[:2], perm, neg, qs, PRIMES[2])
    with pytest.raises(ValueError, match="parts must be"):
        ks.ks_finish(parts[:2], y, y, y, perm, neg, qs, PRIMES[2])
    with pytest.raises(ValueError, match="parts must be"):
        ks.ks_finish([a.long() for a in parts], y, y, y, perm, neg, qs,
                     PRIMES[2])
    with pytest.raises(ValueError, match="parts must be"):
        ks.ks_finish([a[:4] for a in parts], y, y, y, perm, neg, qs,
                     PRIMES[2])
    with pytest.raises(ValueError, match=r"\(1, 2\^30\)"):
        ks.ks_finish(parts, y, y, y, perm, neg, qs, 1)
    with pytest.raises(ValueError, match="tensors on"):
        ks.ks_finish(parts, y, y, y.to("meta"), perm, neg, qs, PRIMES[2])
