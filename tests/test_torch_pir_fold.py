"""The PIR dim-1 fold's wrapper on the CPU (ops/pir_fold.py): CPU tensors
take the plain version, whose canonical int32 sums equal the int64
``addcmul_`` loop ``DevicePIR2._fold_dim1`` ran before and an exact sum of
products reduced term by term, the selectors passed as the strided view
``sel[:, :g1]``; what the kernel would refuse is refused before any build;
the kernel's lazy reduction (``csrc/pir_fold1.cu``: SPAN products between
two folds hi·2^32 + lo → hi·c + lo) cannot wrap its u64 sums for any
modulus below 2^30 and, emulated in Python integers, gives the canonical
sum. The kernel itself runs in tests/test_torch_cuda.py on the card.

This file imports only torch and the port."""

import re

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.crypto.params import find_ntt_primes
from prefhetch_tpu_torch.ops import pir_fold
from prefhetch_tpu_torch.utils import cuda_build

N = 64
QS = tuple(find_ntt_primes(4096, 30, 2))


def _operands(S, g1, g2, fill, seed=0, qs=QS, n=N):
    """(sel [S, g1 + g2, 2, L, n], db [g1, g2, L, n]) int32 residues below
    each limb's modulus: uniform, or every one q - 1."""
    L = len(qs)
    q = np.array(qs, np.int64)[:, None]
    rng = np.random.default_rng(seed)
    if fill == "q-1":
        sel = np.broadcast_to(q - 1, (S, g1 + g2, 2, L, n))
        db = np.broadcast_to(q - 1, (g1, g2, L, n))
    else:
        sel = rng.integers(0, q, (S, g1 + g2, 2, L, n))
        db = rng.integers(0, q, (g1, g2, L, n))
    return (torch.from_numpy(np.ascontiguousarray(sel, np.int32)),
            torch.from_numpy(np.ascontiguousarray(db, np.int32)))


def _int64_loop(s1, db, qs):
    """DevicePIR2._fold_dim1 as it was: int64 sums, reduced every 7 rows."""
    S, rows = s1.shape[:2]
    q = torch.tensor(qs, dtype=torch.int64)[:, None]
    acc = torch.zeros((S, 2, db.shape[1]) + tuple(db.shape[2:]),
                      dtype=torch.int64)
    for i in range(rows):
        acc.addcmul_(s1[:, i, :, None], db[i])
        if (i + 1) % 7 == 0 or i + 1 == rows:
            acc %= q
    return acc


def _exact(s1, db, qs):
    """Σ_i (s1_i · db_i mod q) mod q, each term reduced on its own."""
    q = torch.tensor(qs, dtype=torch.int64)[:, None]
    out = torch.zeros((s1.shape[0], 2, db.shape[1]) + tuple(db.shape[2:]),
                      dtype=torch.int64)
    for i in range(s1.shape[1]):
        out += s1[:, i, :, None].long() * db[i].long() % q
    return out % q


@pytest.mark.parametrize("S,g1,g2,fill", [
    (1, 13, 13, "uniform"), (3, 13, 11, "uniform"), (3, 13, 13, "q-1"),
    (5, 20, 9, "q-1"),
])
def test_cpu_takes_the_plain_version_equal_to_the_int64_loop(S, g1, g2,
                                                             fill):
    sel, db = _operands(S, g1, g2, fill, seed=S + g1)
    s1 = sel[:, :g1]                          # strided, as the program's
    assert s1.stride(0) == sel.stride(0) != g1 * s1.stride(1)
    launches = pir_fold.fold_dim1.launches
    calls = pir_fold.fold_dim1_plain.calls
    got = pir_fold.fold_dim1(s1, db, QS)
    assert pir_fold.fold_dim1.launches == launches
    assert pir_fold.fold_dim1_plain.calls == calls + 1
    assert got.dtype == torch.int32 and got.shape == (S, 2, g2, 2, N)
    q = torch.tensor(QS, dtype=torch.int32)[:, None]
    assert bool((got >= 0).all()) and bool((got < q).all())
    assert torch.equal(got.long(), _int64_loop(s1, db, QS))
    assert torch.equal(got.long(), _exact(s1, db, QS))


def test_device_fold_takes_the_wrapper_on_a_shard():
    """DevicePIR2._fold_dim1 is the wrapper over the service's moduli; a
    shard of database rows with its slice of selectors folds to the partial
    the shards' int64 sum reassembles."""
    from prefhetch_tpu_torch.crypto.params import pir_params_for
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

    p = pir_params_for(256, 257, 2)
    base = np.random.default_rng(4).integers(0, 256, (600, 32)) \
        .astype(np.float32)
    svc = DevicePIR2(base, p, device="cpu")
    sel, _ = _operands(2, svc.g1, svc.g2, "uniform", seed=9, qs=p.qs,
                       n=p.n)
    s1 = sel[:, :svc.g1]
    whole = svc._fold_dim1(s1)
    assert whole.dtype == torch.int32
    assert torch.equal(whole.long(), _exact(s1, svc.db, p.qs))
    h = svc.g1 // 2
    parts = [svc._fold_dim1(s1[:, a:b], svc.db[a:b])
             for a, b in ((0, h), (h, svc.g1))]
    q = torch.tensor(p.qs, dtype=torch.int64)[:, None]
    assert torch.equal((parts[0].long() + parts[1].long()) % q, whole.long())


@pytest.mark.parametrize("q", [
    *QS, (1 << 30) - 1, (1 << 29) + 11, 65537, 3, 2,
])
def test_lazy_reduction_cannot_wrap_and_is_exact(q):
    """The kernel's bound: after two folds any u64 is below B2, and B2 plus
    SPAN products of at most (q-1)^2 stays below 2^64; a fold of a value
    below that bound stays below 2^64 too. Then the kernel's arithmetic in
    Python integers over 177 rows of q - 1 (and of random residues) gives
    the canonical sum, every partial below 2^64."""
    span = pir_fold.SPAN
    c = (1 << 32) % q
    top = (1 << 32) - 1

    def fold(x):
        return (x >> 32) * c + (x & top)

    b1 = top * c + top                         # fold of any u64
    b2 = (b1 >> 32) * c + top                  # and again
    assert b2 + span * (q - 1) ** 2 < 1 << 64
    rng = np.random.default_rng(q % 1000)
    for vals in ([q - 1] * 177, rng.integers(0, q, 177).tolist()):
        for y in ([q - 1] * 177, rng.integers(0, q, 177).tolist()):
            acc, left = 0, span
            for a, b in zip(vals, y):
                acc += a * b
                assert acc < 1 << 64
                left -= 1
                if left == 0:
                    acc, left = fold(fold(acc)), span
            assert fold(fold(acc)) % q == sum(a * b for a, b in
                                              zip(vals, y)) % q


def test_kernel_source_holds_the_constants_the_wrapper_states():
    src = (cuda_build.CSRC / "pir_fold1.cu").read_text()
    assert re.search(rf"constexpr int SPAN = {pir_fold.SPAN};", src)
    assert re.search(rf"constexpr int MAX_LIMBS = {pir_fold.MAX_LIMBS};",
                     src)
    assert 'extern "C" int pfh_pir_fold1(' in src


def test_refusals_before_any_build():
    sel, db = _operands(2, 5, 4, "uniform")
    s1 = sel[:, :5]
    with pytest.raises(ValueError, match="int32"):
        pir_fold.fold_dim1(s1.long(), db, QS)
    with pytest.raises(ValueError, match="int32"):
        pir_fold.fold_dim1(s1, db.long(), QS)
    with pytest.raises(ValueError, match="does not match"):
        pir_fold.fold_dim1(sel[:, :4], db, QS)         # rows 4 vs 5
    with pytest.raises(ValueError, match="does not match"):
        pir_fold.fold_dim1(s1[..., :32], db, QS)       # N 32 vs 64
    with pytest.raises(ValueError, match=r"\[S, rows, 2, L, N\]"):
        pir_fold.fold_dim1(s1[:, :, :1], db, QS)
    with pytest.raises(ValueError, match=r"\[rows, g2, L, N\]"):
        pir_fold.fold_dim1(s1, db[0], QS)
    with pytest.raises(ValueError, match="above 0"):
        pir_fold.fold_dim1(s1[:0], db, QS)
    with pytest.raises(ValueError, match="one modulus each"):
        pir_fold.fold_dim1(s1, db, QS[:1])
    with pytest.raises(ValueError, match="multiple of 32"):
        pir_fold.fold_dim1(s1[..., :48], db[..., :48], QS)
    with pytest.raises(ValueError, match=r"\(1, 2\^30\)"):
        pir_fold.fold_dim1(s1, db, (QS[0], 1 << 30))
    with pytest.raises(ValueError, match="contiguous in their last three"):
        pir_fold.fold_dim1(s1.transpose(3, 4).contiguous().transpose(3, 4),
                           db, QS)
    with pytest.raises(ValueError, match="contiguous in their last three"):
        pir_fold.fold_dim1(s1, db.transpose(2, 3).contiguous()
                           .transpose(2, 3), QS)
    with pytest.raises(ValueError, match="is on"):
        pir_fold.fold_dim1(s1, db.to("meta"), QS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pir_fold.fold_dim1(s1.to("meta"), db.to("meta"), QS)
