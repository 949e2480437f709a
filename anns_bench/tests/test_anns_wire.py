"""The frozen client copies give the program's bytes and answers."""

import numpy as np

from anns_bench.client import wire
from anns_bench.client.ranking import nearest_centroids
from prefhetch_tpu_torch.utils import wire_bin


def test_wire_copy_gives_the_programs_bytes():
    rng = np.random.default_rng(0)
    secs = [rng.random((64, 128), np.float32),
            rng.integers(0, 1024, (64, 16)).astype(np.int64),
            np.asarray([100], np.uint32)]
    for kind in (wire.KIND_SEARCH_REQ, wire.KIND_COARSE_TOPK_REQ):
        assert wire.encode(kind, secs) == wire_bin.encode(kind, secs)
    resp = wire_bin.encode(wire_bin.KIND_SEARCH, [
        rng.integers(0, 10**6, (3, 100)).astype(np.int64),
        rng.random((3, 100), np.float32)])
    k1, s1 = wire.decode(resp)
    k2, s2 = wire_bin.decode(resp)
    assert k1 == k2 == wire.KIND_SEARCH
    assert all(np.array_equal(a, b) for a, b in zip(s1, s2))
    assert wire.KIND_SEARCH == wire_bin.KIND_SEARCH
    assert wire.KIND_COARSE_TOPK == wire_bin.KIND_COARSE_TOPK
    assert wire.CONTENT_TYPE == wire_bin.CONTENT_TYPE


def test_ranking_matches_the_programs_client():
    from prefhetch_tpu_torch.client.pipeline import ClientPipeline

    rng = np.random.default_rng(1)
    cents = rng.random((256, 128)).astype(np.float32) * 255
    q = np.round(rng.random((100, 128)) * 255).astype(np.float32)
    _, order = ClientPipeline.sort_nearest_centroids(None, q, cents)
    assert np.array_equal(nearest_centroids(q, cents, 16), order[:, :16])
