import numpy as np
import torch

from anns_bench.data import make_sift_style

SPEC = dict(nbase=2000, ntrain=500, nquery=50, d=128, n_clusters=20,
            center_range=[30.0, 225.0], scale_range=[8.0, 30.0], value_max=255, corpus_seed=3)


def test_same_seed_same_arrays():
    a = make_sift_style(SPEC, 2**31 + 7, torch.device("cpu"))
    b = make_sift_style(SPEC, 2**31 + 7, torch.device("cpu"))
    for k in ("base", "train", "query"):
        assert np.array_equal(a[k], b[k])


def test_the_seed_draws_the_queries_the_corpus_stays():
    a = make_sift_style(SPEC, 1, torch.device("cpu"))
    b = make_sift_style(SPEC, 2, torch.device("cpu"))
    assert np.array_equal(a["base"], b["base"])
    assert np.array_equal(a["train"], b["train"])
    assert not np.array_equal(a["query"], b["query"])
    c = make_sift_style(dict(SPEC, corpus_seed=4), 1, torch.device("cpu"))
    assert not np.array_equal(a["base"], c["base"])
    assert a["base"].shape == b["base"].shape == (2000, 128)
    assert a["query"].shape == (50, 128) and a["train"].shape == (500, 128)


def test_sift_style_values():
    a = make_sift_style(SPEC, 5, torch.device("cpu"))
    x = a["base"]
    assert x.dtype == np.float32
    assert x.min() >= 0 and x.max() <= 255
    assert np.array_equal(x, np.round(x))


def test_a_query_seed_fixes_the_pool():
    spec = dict(SPEC, query_seed=9)
    a = make_sift_style(spec, 1, torch.device("cpu"))
    b = make_sift_style(spec, 2**31 + 7, torch.device("cpu"))
    assert np.array_equal(a["query"], b["query"])
    c = make_sift_style(dict(SPEC, query_seed=10), 1, torch.device("cpu"))
    assert not np.array_equal(a["query"], c["query"])
