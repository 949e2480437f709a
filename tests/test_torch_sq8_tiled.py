"""K4's tile-major schedule on the CPU (ops/slab_scan.py ``sq8_schedule``,
``sq8_runs``): the flat (query, slot) pairs sorted by tile, cut into chunks
of ``SQ8_CHUNK`` and runs of one tile, as the kernel's blocks walk them.

The schedule must cover every pair exactly once, with each run inside one
chunk and on one tile. A plain walk of the runs (each tile decoded once per
run, then every pair of the run scored against it) must give the plain
version's distances, which the JAX package's Pallas kernel ties down in
tests/test_torch_scan.py. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prefhetch_tpu.ops import pallas_scan as jp
from prefhetch_tpu_torch.ops import slab_scan as k45

torch.set_num_threads(1)

C = k45.SQ8_CHUNK
NTILES = 9                    # tiles 0..8 and the empty tile 9


def _probes(case):
    """probe_ids [nq, max_t] for each hard case of the schedule."""
    rng = np.random.default_rng(len(case))
    if case == "tile probed by every query":
        p = rng.integers(0, NTILES, (24, 3))
        p[:, 1] = 4                           # a run of 24 > C pairs
    elif case == "empty-tile run":
        p = rng.integers(0, NTILES, (6, 8))
        p[:, 5:] = NTILES                     # every query's padding
    elif case == "a query probes one tile twice":
        p = rng.integers(0, NTILES, (5, 4))
        p[2, 1] = p[2, 3] = 6
    elif case == "nq*max_t not a multiple of C":
        p = rng.integers(0, NTILES + 1, (5, 3))
    else:                                     # random, several chunks
        p = rng.integers(0, NTILES + 1, (16, 6))
    return torch.from_numpy(p.astype(np.int32))


CASES = ["tile probed by every query", "empty-tile run",
         "a query probes one tile twice", "nq*max_t not a multiple of C",
         "random"]


@pytest.mark.parametrize("case", CASES)
def test_schedule_covers_every_pair_once(case):
    probes = _probes(case)
    flat = probes.reshape(-1)
    P = flat.numel()
    tiles, order = k45.sq8_schedule(probes, NTILES + 1)
    assert tiles.dtype == torch.int16 and order.dtype == torch.int64
    tiles = tiles.to(torch.int32)
    # a stable sort: a permutation of the pairs, tiles ascending, pairs of
    # one tile in their original order
    assert sorted(order.tolist()) == list(range(P))
    assert torch.equal(tiles, flat[order.long()])
    assert bool((tiles[1:] >= tiles[:-1]).all())
    same = tiles[1:] == tiles[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    block, start, length, tile = k45.sq8_runs(tiles)
    # every sorted position in exactly one run; runs inside one chunk, on
    # one tile, and maximal within their chunk
    covered = torch.zeros(P, dtype=torch.int64)
    for b, s, n, t in zip(block.tolist(), start.tolist(), length.tolist(),
                          tile.tolist()):
        assert n >= 1 and s // C == b == (s + n - 1) // C
        assert bool((tiles[s:s + n] == t).all())
        covered[s:s + n] += 1
    assert bool((covered == 1).all())
    assert int(block.max()) + 1 == -(-P // C)
    nxt = start[1:]
    assert bool(((block[1:] != block[:-1]) | (tile[1:] != tile[:-1])).all())
    assert torch.equal(nxt, start[:-1] + length[:-1])
    # a tile is read at most once per chunk it appears in
    for t in torch.unique(flat).tolist():
        chunks = torch.unique(torch.nonzero(tiles == t)[:, 0] // C)
        assert int((tile == t).sum()) == chunks.numel()


def test_schedule_keys_widen_past_int16():
    """Tile ids that do not fit int16 sort as int32, to the same order."""
    probes = _probes("random") * 4000
    tiles, order = k45.sq8_schedule(probes, 40000)
    assert tiles.dtype == torch.int32
    assert torch.equal(order, k45.sq8_schedule(probes // 4000, NTILES + 1)[1])


def _sq8_inputs(T=32, d=32, seed=0):
    rng = np.random.default_rng(seed)
    sizes = np.array([T, 1, T - 1, 0, T // 2, T, 3, T, 2, 0], np.int32)
    codes = rng.integers(0, 256, (NTILES + 1, T, d)).astype(np.uint8)
    for i, s in enumerate(sizes):
        codes[i, s:] = 0
    vmin = (rng.random(d) * 10 - 5).astype(np.float32)
    scale = (rng.random(d) * 0.8 + 0.2).astype(np.float32)
    dec = vmin + (codes.astype(np.float32) + 0.5) * scale
    norms = (dec * dec).sum(-1).astype(np.float32)
    return [torch.from_numpy(a) for a in (codes, norms, sizes, vmin, scale)]


def _walk_runs(codes, norms, sizes, vmin, scale, queries, probes):
    """K4's schedule walked in plain torch: per run, the tile's codes are
    decoded once (code + ½) and every pair of the run scored against them;
    each pair's row of T lands at out[pair·T:]. Returns the distances and
    how often each output row was written."""
    nq, max_t = probes.shape
    T = codes.shape[1]
    tiles, order = k45.sq8_schedule(probes, NTILES + 1)
    _, start, length, tile = k45.sq8_runs(tiles)
    out = torch.full((nq * max_t, T), float("nan"))
    writes = torch.zeros(nq * max_t, dtype=torch.int64)
    q = queries.float()
    for s, n, t in zip(start.tolist(), length.tolist(), tile.tolist()):
        size = int(sizes[t])
        x = codes[t].float() + 0.5 if size > 0 else None   # one decode a run
        for p in order[s:s + n].long().tolist():
            qi = p // max_t
            row = torch.full((T,), 3.4e38)
            if size > 0:
                cross = x @ (scale * q[qi]) + torch.dot(vmin, q[qi])
                d2 = torch.dot(q[qi], q[qi]) + norms[t] - 2.0 * cross
                row = torch.where(torch.arange(T) < size,
                                  torch.clamp(d2, min=0.0), row)
            out[p] = row
            writes[p] += 1
    return out.reshape(nq, max_t * T), writes


@pytest.mark.parametrize("case", CASES)
def test_schedule_walk_equals_plain_and_pallas(case):
    """Scoring the pairs run by run gives the plain version's distances
    (f32 sums in another order: 1e-5 of ‖q‖² + max ‖x̂‖²), writes every
    pair's row once, and agrees with the Pallas SQ8 kernel."""
    probes = _probes(case)
    codes, norms, sizes, vmin, scale = _sq8_inputs(seed=len(case))
    q = torch.from_numpy(np.abs(np.random.default_rng(3).normal(
        scale=40.0, size=(probes.shape[0], codes.shape[2]))).astype(
            np.float32))
    got, writes = _walk_runs(codes, norms, sizes, vmin, scale, q, probes)
    assert bool((writes == 1).all())
    want = k45.slab_distances_sq8(codes, norms, sizes, vmin, scale, q, probes)
    pad = want >= 1.7e38
    assert torch.equal(got >= 1.7e38, pad)
    tol = 1e-5 * ((q * q).sum(-1)[:, None] + norms.max())
    err = torch.where(pad, torch.zeros_like(got), (got - want).abs())
    assert bool((err <= tol).all())
    j = np.asarray(jp.pallas_slab_distances_sq8(
        *(jnp.asarray(a.numpy()) for a in (codes, norms, sizes, vmin, scale,
                                           q, probes)), interpret=True))
    jpad = j >= 1.7e38
    np.testing.assert_array_equal(jpad, pad.numpy())
    np.testing.assert_allclose(np.where(jpad, 0, got.numpy()),
                               np.where(jpad, 0, j), rtol=0,
                               atol=float(tol.max()))


def test_kernel_refuses_what_its_shared_memory_cannot_hold():
    """K4 stages 8 warps' rings of code rows and the chunk's scaled
    queries: a d past the block's shared memory is refused before any
    build; T does not count."""
    assert k45.sq8_smem_bytes(1024, 128) == k45.sq8_smem_bytes(64, 128) == (
        8 * 4 * 8 * 132 + 4 * C * 130 + 12 * C)
    big_d = 16 * (k45._MAX_SMEM // (16 * 8 * 4 * 8) + 1)
    codes = torch.zeros((2, 4, big_d), dtype=torch.uint8)
    norms = torch.zeros((2, 4))
    sizes = torch.zeros(2, dtype=torch.int32)
    aff = torch.ones(big_d)
    q = torch.zeros((1, big_d))
    probes = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        k45._check(codes, norms, sizes, q, probes, (torch.uint8,), 16,
                   affine=(("vmin", aff), ("scale", aff)),
                   smem=k45.sq8_smem_bytes)
    d = 128
    k45._check(codes[..., :d].contiguous(), norms, sizes, q[:, :d].contiguous(),
               probes, (torch.uint8,), 16,
               affine=(("vmin", aff[:d].contiguous()),
                       ("scale", aff[:d].contiguous())),
               smem=k45.sq8_smem_bytes)
