"""The judge: exact answers pass, and planted wrong answers (ids shifted,
one decrypted distance off by 1, a short answer, a NaN or infinite
distance) make ``correct`` false."""

import pytest

import numpy as np
import torch

from anns_bench import judge
from anns_bench.reference import Reference

LIMITS = {"failed": 0, "id_faults": 0, "dist_gap": 0, "order_gap": 0,
          "recall_at_100_min": 0.75}


def _world():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (4000, 128)).astype(np.float32)
    q = rng.integers(0, 256, (20, 128)).astype(np.float32)
    ref = Reference(base, torch.device("cpu"))
    return ref, q


def _exact_search(ref, q):
    ids = ref.exact_topk(q, 100)
    return ids, ref.distances(q, ids)


def test_exact_search_answers_pass():
    ref, q = _world()
    ids, d = _exact_search(ref, q)
    numbers, recall = judge.judge_search(ref, q, np.arange(20), ids,
                                         d.astype(np.float32), 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert ok and recall == 1.0 and checks["dist_gap"]["value"] == 0.0


def test_shifted_ids_fail():
    ref, q = _world()
    ids, d = _exact_search(ref, q)
    numbers, _ = judge.judge_search(ref, q, np.arange(20), (ids + 1) % 4000,
                                    d, 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert not ok and checks["dist_gap"]["value"] > 0
    assert checks["recall_at_100"]["value"] < 0.75


def test_one_distance_off_by_one_fails():
    ref, q = _world()
    cand = ref.exact_topk(q, 256)
    dec = ref.distances(q, cand)
    numbers, _ = judge.judge_rerank(ref, q, np.arange(20), cand, dec, 0, 100)
    assert judge.check(numbers, {k: v for k, v in LIMITS.items()
                                 if k != "order_gap"})[0]
    dec[3, 17] += 1
    numbers, _ = judge.judge_rerank(ref, q, np.arange(20), cand, dec, 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert not ok and checks["dist_gap"]["value"] == 1.0


def test_failed_and_repeated_ids_fail():
    ref, q = _world()
    ids, d = _exact_search(ref, q)
    numbers, _ = judge.judge_search(ref, q, np.arange(20), ids, d, 1, 100)
    assert not judge.check(numbers, LIMITS)[0]
    ids[0, 1] = ids[0, 0]
    d = ref.distances(q, ids)
    numbers, _ = judge.judge_search(ref, q, np.arange(20), ids, d, 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert not ok and checks["id_faults"]["value"] == 1


def test_out_of_order_answer_fails():
    ref, q = _world()
    ids, d = _exact_search(ref, q)
    ids[:, [0, 50]] = ids[:, [50, 0]]
    d[:, [0, 50]] = d[:, [50, 0]]
    numbers, _ = judge.judge_search(ref, q, np.arange(20), ids, d, 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert not ok and checks["order_gap"]["value"] > 0


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_distance_fails(bad):
    ref, q = _world()
    ids, d = _exact_search(ref, q)
    d[2, 5] = bad
    numbers, _ = judge.judge_search(ref, q, np.arange(20), ids, d, 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert not ok and checks["dist_gap"]["value"] == float("inf")
    cand = ref.exact_topk(q, 256)
    dec = ref.distances(q, cand)
    dec[7, 200] = bad
    numbers, _ = judge.judge_rerank(ref, q, np.arange(20), cand, dec, 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert not ok and checks["dist_gap"]["value"] == float("inf")


def test_out_of_corpus_id_is_an_id_fault_not_a_distance():
    ref, q = _world()
    ids, d = _exact_search(ref, q)
    ids[4, 9] = 4000
    numbers, _ = judge.judge_search(ref, q, np.arange(20), ids, d, 0, 100)
    ok, checks = judge.check(numbers, LIMITS)
    assert not ok and checks["id_faults"]["value"] == 1
    assert np.isfinite(checks["dist_gap"]["value"])
