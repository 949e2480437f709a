"""The comparison that decides ``correct``.

Every answer the window produced is held to the plain reference
(reference.py), once the window has closed. A number is compared with its
limit from the configuration's ``checks`` block; the run is correct when
every number is within its limit. The numbers:

- ``failed``: requests sent in the window that got an error, a malformed
  answer, an answer of the wrong shape, or none;
- ``id_faults``: returned ids outside the corpus, or repeated in one
  answer;
- ``dist_gap``: the widest gap between a returned (or decrypted) distance
  and the reference's float64 distance of the same id (the configuration
  states exact distances: integer vectors, float32 products);
- ``order_gap``: the widest step down in reference distance along a
  returned list (answers come back nearest first);
- ``recall_at_100``: the final top-100 against the exact top-100, over
  every distinct query answered, at least the configuration's floor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from anns_bench.reference import Reference


def _id_faults(ids: np.ndarray, nbase: int) -> int:
    bad = int(((ids < 0) | (ids >= nbase)).sum())
    s = np.sort(ids, axis=1)
    return bad + int((s[:, 1:] == s[:, :-1]).sum())


def _hits(ids: np.ndarray, truth: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """Per row, how many of ``truth``'s ids ``ids`` holds."""
    out = np.empty(len(ids), np.int64)
    for s in range(0, len(ids), chunk):
        t, a = truth[s: s + chunk], ids[s: s + chunk]
        out[s: s + chunk] = (t[:, :, None] == a[:, None, :]).any(2).sum(1)
    return out


def _recall(qidx: np.ndarray, hits: np.ndarray, k: int) -> float:
    """Mean over distinct queries of the mean share of their answers."""
    uq, inv = np.unique(qidx, return_inverse=True)
    per_q = np.bincount(inv, weights=hits / k) / np.bincount(inv)
    return float(per_q.mean()) if len(uq) else 0.0


def _gap(ref: np.ndarray, got: np.ndarray) -> float:
    """Widest |got - ref|. Positions where the reference is NaN (an id
    outside the corpus, which ``id_faults`` counts) are skipped; a
    non-finite distance the program returned is an infinite gap."""
    keep = ~np.isnan(ref)
    got = got[keep]
    if not np.isfinite(got).all():
        return float("inf")
    d = np.abs(got - ref[keep])
    return float(d.max()) if d.size else 0.0


def check(numbers: Dict[str, float], limits: dict) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "max" | "min"}}) in a fixed order."""
    out, ok = {}, True
    for name, value in numbers.items():
        if name + "_min" in limits:
            lim = float(limits[name + "_min"])
            out[name] = {"value": value, "min": lim}
            ok &= value >= lim
        else:
            lim = float(limits[name])
            out[name] = {"value": value, "max": lim}
            ok &= value <= lim
    return bool(ok), out


def judge_search(ref: Reference, queries: np.ndarray, qidx: np.ndarray,
                 ids: np.ndarray, dists: np.ndarray, failed: int, k: int,
                 chunk: int = 2048) -> Tuple[Dict[str, float], float]:
    """/search answers: ``qidx`` [n] the pool row of each answered query,
    ``ids`` [n, k], ``dists`` [n, k]. Returns (numbers, recall@k)."""
    nbase = ref.base.shape[0]
    faults = _id_faults(ids, nbase) if len(ids) else 0
    dist_gap = order_gap = 0.0
    for s in range(0, len(ids), chunk):
        sl = slice(s, s + chunk)
        d_ref = ref.distances(queries[qidx[sl]], ids[sl])
        dist_gap = max(dist_gap, _gap(d_ref, dists[sl].astype(np.float64)))
        steps = d_ref[:, :-1] - d_ref[:, 1:]
        steps = steps[~np.isnan(steps)]
        if steps.size:
            order_gap = max(order_gap, float(steps.max()))
    uq = np.unique(qidx)
    truth_u = ref.exact_topk(queries[uq], k) if len(uq) else np.empty((0, k))
    truth = truth_u[np.searchsorted(uq, qidx)]
    recall = _recall(qidx, _hits(ids, truth), k)
    return ({"failed": float(failed), "id_faults": float(faults),
             "dist_gap": dist_gap, "order_gap": order_gap,
             "recall_at_100": recall}, recall)


def judge_rerank(ref: Reference, queries: np.ndarray, qidx: np.ndarray,
                 cand: np.ndarray, dec: np.ndarray, failed: int, k: int,
                 chunk: int = 2048) -> Tuple[Dict[str, float], float]:
    """Two-round answers: ``cand`` [n, P] the coarse round's candidates,
    ``dec`` [n, P] their decrypted distances. The final answer is the k
    nearest candidates by decrypted distance (the client's selection)."""
    nbase = ref.base.shape[0]
    faults = _id_faults(cand, nbase) if len(cand) else 0
    gap = 0.0
    for s in range(0, len(cand), chunk):
        sl = slice(s, s + chunk)
        gap = max(gap, _gap(ref.distances(queries[qidx[sl]], cand[sl]), dec[sl]))
    final = np.take_along_axis(
        cand, np.argsort(dec, axis=1, kind="stable")[:, :k], axis=1)
    uq = np.unique(qidx)
    truth_u = ref.exact_topk(queries[uq], k) if len(uq) else np.empty((0, k))
    truth = truth_u[np.searchsorted(uq, qidx)]
    recall = _recall(qidx, _hits(final, truth), k)
    return ({"failed": float(failed), "id_faults": float(faults),
             "dist_gap": gap, "recall_at_100": recall}, recall)
