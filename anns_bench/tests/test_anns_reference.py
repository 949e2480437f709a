import numpy as np
import torch

from anns_bench.reference import Reference, bf16_distances, bf16_topk


def _float64_brute(base, q, k):
    d = ((q[:, None, :].astype(np.float64) - base[None].astype(np.float64))
         ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k], d


def test_exact_topk_equals_float64_brute_force():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (3000, 128)).astype(np.float32)
    base[10] = base[20]           # ties: the lower id first
    q = rng.integers(0, 256, (40, 128)).astype(np.float32)
    q[0] = base[10]
    ref = Reference(base, torch.device("cpu"))
    want, d = _float64_brute(base, q, 100)
    got = ref.exact_topk(q, 100, block=16)
    assert np.array_equal(got, want)
    assert got[0, 0] == 10 and got[0, 1] == 20
    assert np.array_equal(ref.distances(q, got),
                          np.take_along_axis(d, got, axis=1))


def test_distances_mark_ids_outside_the_corpus():
    base = np.ones((10, 8), np.float32)
    ref = Reference(base, torch.device("cpu"))
    out = ref.distances(np.zeros((1, 8), np.float32), np.array([[0, 10, -1]]))
    assert out[0, 0] == 8.0 and np.isnan(out[0, 1:]).all()


def test_bf16_control_differs_from_exact():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (3000, 128)).astype(np.float32)
    q = rng.integers(0, 256, (8, 128)).astype(np.float32)
    ref = Reference(base, torch.device("cpu"))
    ids, d = bf16_topk(ref, q, 100)
    assert np.abs(ref.distances(q, ids) - d).max() > 0
    cand = ref.exact_topk(q, 256)
    assert np.abs(bf16_distances(ref, q, cand) - ref.distances(q, cand)).max() > 0
