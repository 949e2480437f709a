"""The roofline counts: the contract's work, counted from the shapes the
kernel path is called with, equals a plain recount from the protocol's own
numbers (each query's probed candidates)."""

import numpy as np
import torch

from anns_bench import roofline
from anns_bench.data import make_sift_style


def _engine():
    from prefhetch_tpu_torch.engine.server import QueryEngine
    from prefhetch_tpu_torch.index.build import build_ivf_index
    from prefhetch_tpu_torch.utils.config import (
        IndexParams, PipelineConfig, ProtocolParams)

    spec = dict(nbase=6000, ntrain=6000, nquery=32, d=128, n_clusters=12,
                center_range=[30.0, 225.0], scale_range=[8.0, 30.0],
                value_max=255, corpus_seed=11)
    data = make_sift_style(spec, 11, torch.device("cpu"))
    params = IndexParams(d=128, nlist=32, pq_m=32, pq_nbits=8, balance=1.25)
    idx = build_ivf_index(data["train"], data["base"], params, "cpu")
    eng = QueryEngine(PipelineConfig(index=params, protocol=ProtocolParams(
        nprobe=6, coarse_probe=256, k=100, nquery=32), nbase=6000),
        device="cpu")
    eng.serve_tile = 64
    eng.set_index(idx, data["base"])
    return eng, data


def test_scan_work_equals_a_plain_recount():
    eng, data = _engine()
    cents = eng.index.centroids.numpy()
    q = data["query"]
    d2 = ((q[:, None, :] - cents[None]) ** 2).sum(-1)
    probes = np.argsort(d2, axis=1, kind="stable")[:, :6]
    tile_idx, _, union, pos, counts = eng._tiled_batch_prep(probes, q)
    view = eng._tiled_view
    T, d, j = view.tile, 128, 4
    nbytes, flops = roofline.scan_work(view.tile_sizes_np, union.numpy(),
                                       pos.numpy(), d=d, tile=T, j_keep=j)
    # every row of each query's own probed lists, counted from the lists
    sizes = eng.index.list_sizes.numpy()
    assert flops == 2 * d * sizes[probes].sum() == 2 * d * counts.sum()
    u = np.unique(tile_idx)
    rows_in = int(view.tile_sizes_np[u].sum())
    nq, mt = tile_idx.shape
    U = len(union)
    want = (rows_in * (2 * d + 4) + 8 * U + 4 * nq * mt + 4 * nq * d
            + 2 * nq * j * T + 8 * nq * j)
    assert nbytes == want


def test_bound_takes_the_larger_side():
    b, by = roofline.bound_s(3.35e12, 0.0)
    assert (b, by) == (1.0, "bytes")
    b, by = roofline.bound_s(1.0, 989e12 * 2)
    assert (b, by) == (2.0, "flops")


def test_ntt_work_counts_input_output_tables_once():
    assert roofline.ntt_work(10, 4096, 8, 64, 64) == (
        10 * 4096 * 8 + 10 * 4096 * 4 + 4 * 3 * 64 * 64)
