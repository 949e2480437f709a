"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped and the rest of a run is driven on the
CPU at a small size, once for each fault the cells can have (an answer
altered where it is produced; half of the batch left out). No cell has a
state that a step carries or an exchange between chips."""

import numpy as np
import pytest

from anns_bench import run
from anns_bench.tests.small import small_cell
from prefhetch_tpu_torch.engine.server import QueryEngine


def _run(name, seconds=0.5):
    return run.execute(small_cell(name), 2**31 + 99, seconds, False,
                       device="cpu")


def _shift_ids(orig):
    def fused(self, q, probes, k):
        resolve = orig(self, q, probes, k)

        def altered():
            ids, d = resolve()
            return (ids + 1) % self.base.shape[0], d
        return altered
    return fused


def _half_batch(orig):
    def fused(self, q, probes, k):
        resolve = orig(self, q, probes, k)

        def half():
            ids, d = resolve()
            n = max(1, len(ids) // 2) if len(ids) > 1 else 0
            return ids[:n], d[:n]
        return half
    return fused


def test_sound_search_run_is_correct():
    out = _run("sift1m-ivfpq-triage.search-b64")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_shift_ids, _half_batch])
def test_broken_search_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(QueryEngine, "search_fused_async",
                        fault(QueryEngine.search_fused_async))
    out = _run("sift1m-ivfpq-triage.search-b64")
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]


def _norm_off_by_one(orig):
    def enc(self, queries, cand, **kw):
        out = orig(self, queries, cand, **kw)
        out["candidateNorms"][0][0] += 1
        return out
    return enc


def _half_encrypted_batch(orig):
    def enc(self, queries, cand, **kw):
        n = len(queries) // 2
        return orig(self, queries[:n], np.asarray(cand)[:n], **kw)
    return enc


def test_sound_encrypted_run_is_correct():
    out = _run("sift1m-bfv-packed.rerank-b64")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_norm_off_by_one, _half_encrypted_batch])
def test_broken_encrypted_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(QueryEngine, "encrypted_precise_search",
                        fault(QueryEngine.encrypted_precise_search))
    out = _run("sift1m-bfv-packed.rerank-b64")
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]
