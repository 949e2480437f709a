"""The tile-major schedule of K4 and K5 on the CPU (ops/slab_scan.py
``tile_schedule``, ``tile_runs``): the flat (query, slot) pairs sorted by
tile, cut into K4's fixed chunks of ``SQ8_CHUNK`` or K5's pieces of at most
``SLAB_CHUNK`` pairs of one tile, as the kernels' blocks walk them.

The schedule must cover every pair exactly once, with each run inside one
chunk (K4) or piece (K5) and on one tile. A plain emulation of the schedule
kernel's own steps (csrc/tile_schedule.cu: histogram, scan, a stable scatter
by warps that own keys, the piece list) must equal ``torch.sort(stable=
True)`` bit for bit. A plain walk of the runs (each tile decoded or widened
once per run, then every pair of the run scored against it) must give the
plain version's distances and the JAX package's Pallas kernel's. The
kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prefhetch_tpu.ops import pallas_scan as jp
from prefhetch_tpu_torch.ops import slab_scan as k45

torch.set_num_threads(1)

C = k45.SQ8_CHUNK
NTILES = 9                    # tiles 0..8 and the empty tile 9
PRESET_TILES = 1474           # the SIFT1M slab view: 1,473 tiles + empty


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
    elif case == "the path's batch shape":    # 64 x 48 over a preset view,
        p = rng.zipf(1.3, (64, 48)) % (PRESET_TILES - 1)   # skewed, with
        p[:, 40:] = PRESET_TILES - 1          # the empty tile's long run
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
    tiles, order = k45.tile_schedule(probes, NTILES + 1)
    assert tiles.dtype == torch.int16 and order.dtype == torch.int64
    tiles = tiles.to(torch.int32)
    # a stable sort: a permutation of the pairs, tiles ascending, pairs of
    # one tile in their original order
    assert sorted(order.tolist()) == list(range(P))
    assert torch.equal(tiles, flat[order.long()])
    assert bool((tiles[1:] >= tiles[:-1]).all())
    same = tiles[1:] == tiles[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    block, start, length, tile = k45.tile_runs(tiles)
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
    tiles, order = k45.tile_schedule(probes, 40000)
    assert tiles.dtype == torch.int32
    assert torch.equal(order, k45.tile_schedule(probes // 4000, NTILES + 1)[1])


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
    tiles, order = k45.tile_schedule(probes, NTILES + 1)
    _, start, length, tile = k45.tile_runs(tiles)
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


# -- the schedule kernel's algorithm, emulated step by step ------------------

SCHEDULE_CASES = CASES + ["the path's batch shape", "ids past int16"]


def _schedule_case(case):
    """(probe_ids, n_tiles): the hard cases, a batch of the path's shape
    over a preset view's 1,474 tiles (counts in shared memory), and tile
    ids up to 39,999 (int32 keys, counts in global scratch)."""
    if case == "ids past int16":
        return _probes("random") * 4000 + 3, 40000
    if case == "the path's batch shape":
        return _probes(case), PRESET_TILES
    return _probes(case), NTILES + 1


def _emulate_schedule(probe_ids, n_tiles, chunk, segs=8):
    """csrc/tile_schedule.cu in numpy, step by step: 1. the keys cut into
    ``segs`` contiguous segments and counted per (segment, key); 2. thread
    tid of 1024 owns a contiguous range of keys, the block scans the
    ranges' totals and pieces, and each thread writes its keys' starts,
    first pieces and per-segment cursors; 3. warp w places segment
    w // (32 / segs), of it the keys k % (32 / segs) == w % (32 / segs),
    32 keys at a time: a lane's place is its key's cursor plus the lanes of
    the window before it with the same key (__match_any_sync), after which
    the cursor moves past the window's lanes of that key, and a pair whose
    rank in its key's run is a multiple of ``chunk`` writes its piece.
    Returns (tiles, order, pieces or None)."""
    keys = probe_ids.reshape(-1).numpy().astype(np.int64)
    P = keys.size
    S = -(-P // segs)
    cnt = np.zeros((segs, n_tiles), np.int64)
    np.add.at(cnt, (np.arange(P) // S, keys), 1)
    tot = cnt.sum(0)
    threads = 1024
    per = -(-n_tiles // threads)
    lo = np.minimum(n_tiles, np.arange(threads) * per)
    hi = np.minimum(n_tiles, lo + per)
    sums = np.array([tot[a:b].sum() for a, b in zip(lo, hi)])
    pcs = np.array([(-(-tot[a:b] // chunk)).sum() if chunk else 0
                    for a, b in zip(lo, hi)])
    run, prun = np.cumsum(sums) - sums, np.cumsum(pcs) - pcs
    first = np.zeros(n_tiles + 1, np.int64)
    pb = np.zeros(n_tiles, np.int64)
    cur = np.zeros((segs, n_tiles), np.int64)
    for tid in range(threads):
        r, pr = run[tid], prun[tid]
        for k in range(lo[tid], hi[tid]):
            first[k], pb[k] = r, pr
            for s in range(segs):
                cur[s, k] = r
                r += cnt[s, k]
            if chunk:
                pr += -(-(r - first[k]) // chunk)
    first[n_tiles] = P
    tiles = np.full(P, -1, np.int64)
    order = np.full(P, -1, np.int64)
    pieces = {}
    classes = 32 // segs
    for warp in range(32):
        cls, seg = warp % classes, warp // classes
        i0, i1 = seg * S, min(P, seg * S + S)
        for base in range(i0, i1, 32):
            win = keys[base:min(base + 32, i1)]
            mine = np.nonzero(win % classes == cls)[0]
            for lane in mine:
                k = win[lane]
                rank = int(np.sum(win[mine[mine < lane]] == k))
                pos = cur[seg, k] + rank
                assert tiles[pos] == -1
                tiles[pos], order[pos] = k, base + lane
                occ = pos - first[k]
                if chunk and occ % chunk == 0:
                    pieces[pb[k] + occ // chunk] = (
                        pos, min(chunk, first[k + 1] - pos))
            for k in np.unique(win[mine]):
                cur[seg, k] += int(np.sum(win[mine] == k))
    dtype = torch.int16 if n_tiles <= 32768 else torch.int32
    out = (torch.from_numpy(tiles).to(dtype), torch.from_numpy(order))
    if not chunk:
        return out + (None,)
    assert sorted(pieces) == list(range(len(pieces)))
    flat = np.array([pieces[p] for p in range(len(pieces))], np.int32)
    return out + (torch.from_numpy(np.concatenate(
        [[len(pieces)], flat.reshape(-1)]).astype(np.int32)),)


@pytest.mark.parametrize("chunk", [0, 2, 4, 8])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_schedule_emulation_equals_stable_sort(case, chunk):
    """The kernel's counting sort gives torch.sort(stable=True) bit for bit
    (keys int16 up to 32,768 tiles, int32 past them), and its piece list is
    the plain schedule's: every run of one tile cut into pieces of at most
    ``chunk`` pairs, no more pieces than the grid the wrapper sizes."""
    probes, n_tiles = _schedule_case(case)
    tiles, order, pieces = _emulate_schedule(probes, n_tiles, chunk)
    key = probes.reshape(-1).to(torch.int16 if n_tiles <= 32768
                                else torch.int32)
    want = torch.sort(key, stable=True)
    assert tiles.dtype == want.values.dtype
    assert torch.equal(tiles, want.values)
    assert torch.equal(order, want.indices)
    plain = k45.tile_schedule(probes, n_tiles, chunk)
    assert torch.equal(plain[0], want.values)
    assert torch.equal(plain[1], want.indices)
    if chunk:
        n = int(pieces[0])
        assert n <= k45.piece_bound(probes.numel(), n_tiles, chunk)
        assert plain[2].numel() == 1 + 2 * k45.piece_bound(
            probes.numel(), n_tiles, chunk)
        assert torch.equal(pieces, plain[2][:1 + 2 * n])


@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_aligned_pieces_cover_every_pair_once(case, chunk):
    """K5's pieces: every sorted pair in exactly one piece, a piece on one
    tile with at most ``chunk`` pairs, a run of up to ``chunk`` pairs never
    split, and a tile read ⌈pairs / chunk⌉ times."""
    probes, n_tiles = _schedule_case(case)
    tiles, _, pieces = k45.tile_schedule(probes, n_tiles, chunk)
    block, start, length, tile = k45.tile_runs(tiles, chunk, aligned=True)
    n = int(pieces[0])
    assert n == start.numel() <= k45.piece_bound(probes.numel(), n_tiles,
                                                  chunk)
    assert torch.equal(block, torch.arange(n))
    assert torch.equal(pieces[1:1 + 2 * n:2].long(), start)
    assert torch.equal(pieces[2:2 + 2 * n:2].long(), length)
    assert bool((length >= 1).all() and (length <= chunk).all())
    assert torch.equal(start[1:], start[:-1] + length[:-1])
    assert int(start[-1] + length[-1]) == probes.numel()
    for s, ln, t in zip(start.tolist(), length.tolist(), tile.tolist()):
        assert bool((tiles[s:s + ln].long() == t).all())
    ids, counts = torch.unique(probes.reshape(-1).long(), return_counts=True)
    for t, c in zip(ids.tolist(), counts.tolist()):
        assert int((tile == t).sum()) == -(-c // chunk)


def test_schedule_on_cpu_takes_the_plain_version():
    """CPU tensors never reach the kernel: the plain version counts the
    call and the wrapper's launches stay put."""
    probes = _probes("random")
    launches = k45.tile_schedule.launches
    calls = k45.tile_schedule_plain.calls
    k45.tile_schedule(probes, NTILES + 1)
    k45.tile_schedule(probes, NTILES + 1, 4)
    assert k45.tile_schedule.launches == launches
    assert k45.tile_schedule_plain.calls == calls + 2


# -- K5 on its schedule ------------------------------------------------------

def _dense_inputs(dtype, T=32, d=32, seed=0):
    """Dense tiles of sizes T, 1, T−1, 0, ... and the empty tile; the bf16
    payload's own values (widened) give the norms, as in the view."""
    rng = np.random.default_rng(seed)
    sizes = np.array([T, 1, T - 1, 0, T // 2, T, 3, T, 2, 0], np.int32)
    x = rng.normal(scale=40.0, size=(NTILES + 1, T, d)).astype(np.float32)
    for i, s in enumerate(sizes):
        x[i, s:] = 0
    payload = torch.from_numpy(x).to(dtype)
    norms = (payload.float() ** 2).sum(-1)
    return payload, norms, torch.from_numpy(sizes)


def _walk_pieces(payload, norms, sizes, queries, probes, chunk):
    """K5's schedule walked in plain torch: per piece, the tile's valid
    rows are widened to f32 once and every pair of the piece scored against
    them; each pair's row of T lands at out[pair·T:]. Returns the distances
    and how often each output row was written."""
    nq, max_t = probes.shape
    T = payload.shape[1]
    tiles, order, pieces = k45.tile_schedule(probes, NTILES + 1, chunk)
    out = torch.full((nq * max_t, T), float("nan"))
    writes = torch.zeros(nq * max_t, dtype=torch.int64)
    for p in range(int(pieces[0])):
        s, n = int(pieces[1 + 2 * p]), int(pieces[2 + 2 * p])
        t = int(tiles[s])
        size = int(sizes[t])
        x = payload[t, :size].float()                # one widening a piece
        for b in order[s:s + n].tolist():
            q = queries[b // max_t]
            row = torch.full((T,), 3.4e38)
            if size > 0:
                d2 = torch.dot(q, q) + norms[t, :size] - 2.0 * (x @ q)
                row[:size] = torch.clamp(d2, min=0.0)
            out[b] = row
            writes[b] += 1
    return out.reshape(nq, max_t * T), writes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CASES)
def test_slab_schedule_walk_equals_plain_and_pallas(case, dtype):
    """Scoring K5's pieces one by one gives the plain version's distances
    (f32 sums in another order: 1e-5 of ‖q‖² + max ‖x‖²), writes every
    pair's row once, and agrees with the Pallas slab kernel."""
    probes = _probes(case)
    payload, norms, sizes = _dense_inputs(dtype, seed=len(case))
    q = torch.from_numpy(np.random.default_rng(5).normal(
        scale=40.0, size=(probes.shape[0], payload.shape[2])).astype(
            np.float32))
    got, writes = _walk_pieces(payload, norms, sizes, q, probes,
                               k45.SLAB_CHUNK)
    assert bool((writes == 1).all())
    want = k45.slab_distances(payload, norms, sizes, q, probes)
    pad = want >= 1.7e38
    assert torch.equal(got >= 1.7e38, pad)
    tol = 1e-5 * ((q * q).sum(-1)[:, None] + norms.max())
    err = torch.where(pad, torch.zeros_like(got), (got - want).abs())
    assert bool((err <= tol).all())
    xj = jnp.asarray(payload.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    j = np.asarray(jp.pallas_slab_distances(
        xj, *(jnp.asarray(a.numpy()) for a in (norms, sizes, q, probes)),
        interpret=True))
    jpad = j >= 1.7e38
    np.testing.assert_array_equal(jpad, pad.numpy())
    np.testing.assert_allclose(np.where(jpad, 0, got.numpy()),
                               np.where(jpad, 0, j), rtol=0,
                               atol=float(tol.max()))


def _slab_check(payload, T, d):
    """K5's argument check as its wrapper makes it, at [2, T, d]."""
    k45._check(payload, torch.zeros((2, T)), torch.zeros(2, dtype=torch.int32),
               torch.zeros((1, d)), torch.zeros((1, 1), dtype=torch.int32),
               (torch.bfloat16, torch.float32), 8)


def test_slab_kernel_refuses_what_its_shared_memory_cannot_hold():
    """K5 stages each warp's ring of payload rows and the piece's queries:
    the operating point (bf16, 16-row steps for the tensor cores) and an
    f32 row of d=200 (8-row steps) fit, a row past a block's shared memory
    is refused before any build; T does not count."""
    tail = 16 * k45.SLAB_CHUNK
    rings = k45.SLAB_WARPS * k45.SLAB_NST

    def bf16(d):
        return rings * (16 * (2 * d + 16) + 64) + 8 * 3 * 32 * -(-d // 16) \
            + tail

    def f32(d):
        return rings * 8 * (4 * d + 4) + 4 * k45.SLAB_CHUNK * d + tail

    b16, f = torch.bfloat16, torch.float32
    assert k45.slab_smem_bytes(1024, 128, b16) == \
        k45.slab_smem_bytes(64, 128, b16) == bf16(128)
    assert k45.slab_smem_bytes(100, 200, f) == f32(200)
    for d, dtype in ((128, b16), (200, f), (400, b16), (424, f)):
        _slab_check(torch.zeros((2, 4, d), dtype=dtype), 4, d)
    with pytest.raises(ValueError, match="shared memory"):
        _slab_check(torch.zeros((2, 4, 432), dtype=f), 4, 432)
    with pytest.raises(ValueError, match="shared memory"):
        _slab_check(torch.zeros((2, 4, 416), dtype=b16), 4, 416)
