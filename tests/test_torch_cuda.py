"""Tests that need the card: kernels K1 to K5 and the tile schedule of K4
and K5 against their plain versions, the engine on CUDA against the engine
on the CPU, the encrypted re-rank service on CUDA against the service on
the CPU (the packed response and its threefry expansion too), the CKKS
device program on CUDA against the CPU (K2 at the CKKS primes too), the
PIR device program on CUDA against the CPU (K2 at its key-switch and
database shapes too), the scan variants of query_pipeline on CUDA
against the CPU, and sharding on the card: the engine over meshes of
shards of the one card byte-identical to the unsharded engine (K1 once a
shard), the q1 MAC and the PIR answer sharded, an NCCL world of one and the
dry run. Without CUDA they skip (one CPU test here checks that
``DevicePIR2`` refuses the card when CUDA is absent). On a machine with an H100 and nvcc (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports only torch and the port, so it runs where JAX is absent."""

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
from prefhetch_tpu_torch.engine.server import QueryEngine
from prefhetch_tpu_torch.index.build import build_ivf_index, index_from_numpy
from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.crypto import bfv as t_bfv
from prefhetch_tpu_torch.crypto import ntt as hostntt
from prefhetch_tpu_torch.crypto.params import find_ntt_primes
from prefhetch_tpu_torch.engine.hecompute import HEComputeService
from prefhetch_tpu_torch.ops import ntt4_fused as k2
from prefhetch_tpu_torch.ops import pq_onehot as k3
from prefhetch_tpu_torch.ops import slab_scan as k45
from prefhetch_tpu_torch.ops import union_scan_min as usm
from prefhetch_tpu_torch.ops.threefry import tf_uniform_rns
from prefhetch_tpu_torch.ops.ntt4 import (
    build_ntt4_tables, fourstep_perm, intt4, ntt4, transform_plain,
)
from prefhetch_tpu_torch.pipeline import query_pipeline
from prefhetch_tpu_torch.utils.config import (
    HEParams, IndexParams, PipelineConfig, ProtocolParams,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the H100)")
    return torch.device("cuda", torch.cuda.current_device())


def _tiles(dev, ntiles, T, d, sizes, dtype, seed):
    """Integer-valued SIFT-like tiles: every f32 product and sum is exact,
    so kernel and plain version agree exactly before the bf16 store."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (ntiles + 1, T, d)).astype(np.float32)
    payload[-1] = 0
    for t, s in enumerate(sizes):
        payload[t, s:] = 0
    p = torch.from_numpy(payload).to(dev, dtype)
    return p, (p.float() ** 2).sum(-1), torch.tensor(sizes, dtype=torch.int32,
                                                     device=dev)


@pytest.mark.parametrize("T,d,nq,dtype", [
    (512, 128, 64, torch.bfloat16),
    (64, 32, 70, torch.bfloat16),
    (100, 200, 5, torch.float32),
    (512, 40, 64, torch.bfloat16),      # K tail: d not a multiple of 16
    (100, 200, 5, torch.bfloat16),      # four feature chunks, T % 8 != 0
    (256, 128, 128, torch.bfloat16),    # two query blocks
])
def test_union_scan_min_kernel_matches_plain(cuda, T, d, nq, dtype):
    sizes = [T, 1, 0, T // 2, 0]
    payload, norms, sizes_t = _tiles(cuda, 4, T, d, sizes, dtype, seed=T + d)
    q = torch.from_numpy(np.random.default_rng(nq).integers(
        0, 256, (nq, d)).astype(np.float32)).to(cuda)
    union = torch.tensor([3, 0, 1, 2, 4, 4], dtype=torch.int32, device=cuda)
    before = usm.union_scan_min.launches
    d2k, mink = usm.union_scan_min(payload, norms, sizes_t, q, union)
    torch.cuda.synchronize()
    assert usm.union_scan_min.launches == before + 1
    d2r, minr = usm.union_scan_min_reference(payload, norms, sizes_t, q,
                                             union)
    assert torch.equal(torch.isinf(d2k), torch.isinf(d2r))
    assert torch.equal(d2k, d2r)          # exact sums, same RN rounding
    assert torch.equal(mink, minr)


def test_union_scan_min_kernel_rejects_what_it_cannot_take(cuda):
    payload, norms, sizes = _tiles(cuda, 2, 64, 12, [64, 3, 0],
                                   torch.bfloat16, seed=1)
    q = torch.zeros((4, 12), device=cuda)
    union = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="divisible by 8"):
        usm.union_scan_min(payload, norms, sizes, q, union)
    payload, norms, sizes = _tiles(cuda, 2, 64, 16, [64, 3, 0],
                                   torch.bfloat16, seed=1)
    q = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        usm.union_scan_min(payload, norms, sizes, q, union.long())
    with pytest.raises(ValueError, match="bf16 or f32"):
        usm.union_scan_min(payload.half(), norms, sizes, q, union)


def test_engine_on_cuda_matches_cpu(cuda, monkeypatch):
    """The whole fused route on the card (through K1) against the same
    route on the CPU (through K1's plain version), same index."""
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    data = make_clustered_dataset(nbase=2048, ntrain=4000, nquery=8, d=32,
                                  n_clusters=40, gt_k=50, seed=9)
    cfg = PipelineConfig(
        index=IndexParams(d=32, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=6, coarse_probe=40, k=10, nquery=4),
        nbase=2048,
    )
    cpu_idx = build_ivf_index(data["train"], data["base"], cfg.index,
                              device="cpu")
    arrays = {
        "centroids": cpu_idx.centroids.numpy(),
        "list_ids": cpu_idx.list_ids.numpy(),
        "list_sizes": cpu_idx.list_sizes.numpy(),
        "list_norms": cpu_idx.list_norms.numpy(),
        "list_codes": cpu_idx.list_codes.numpy(),
        "codebooks": cpu_idx.codebooks.numpy(),
        "list_recon_bf16": cpu_idx.host_arrays["payload"],
    }
    engines = []
    for dev, idx in (("cpu", cpu_idx),
                     (cuda, index_from_numpy(arrays, cfg.index, cuda))):
        e = QueryEngine(cfg, device=dev)
        e.serve_tile = 64
        e.set_index(idx, data["base"])
        engines.append(e)
    q = data["query"]
    cents = engines[0].retrieve_centroids()
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6]
    before = usm.union_scan_min.launches
    ids_c, d_c = engines[0].search_fused(q, probes, 10)
    ids_g, d_g = engines[1].search_fused(q, probes, 10)
    assert usm.union_scan_min.launches == before + 1
    np.testing.assert_array_equal(d_g, d_c)   # exact re-rank, integer data
    for r in range(q.shape[0]):
        assert set(ids_g[r]) == set(ids_c[r])


@pytest.mark.parametrize("n,bsz", [(4096, 33), (8192, 7)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_ntt4_transform_kernel_matches_plain(cuda, n, bsz, inverse, dtype):
    """K2, one launch per transform, at N=4096 (64x64) and N=8192 (64x128),
    odd batches, lazy inputs anywhere in [0, 2^31), negative inputs, int32
    and int64 (low 32 bits): bit-equal to its plain version and canonical."""
    q = find_ntt_primes(n, 30, 2)[1]
    tb = build_ntt4_tables(q, n)
    rng = np.random.default_rng(n + bsz + inverse)
    x = rng.integers(0, 1 << 31, (bsz, n), dtype=np.int64)
    x[0, :4] = [0, q - 1, q, (1 << 31) - 1]
    xc = torch.from_numpy(x).to(cuda, dtype)
    before = k2.ntt4_transform.launches
    got = k2.ntt4_transform(xc, tb, inverse)
    torch.cuda.synchronize()
    assert k2.ntt4_transform.launches == before + 1
    assert got.dtype == torch.int32 and int(got.min()) >= 0
    assert int(got.max()) < q
    assert torch.equal(got, transform_plain(xc, tb, inverse))
    # negative values (int64: low 32 bits a negative int32) are taken as
    # their residue, as the plain version takes them
    neg = -xc - 1
    assert torch.equal(k2.ntt4_transform(neg, tb, inverse),
                       transform_plain(neg, tb, inverse))


@pytest.mark.parametrize("n,bsz", [(4096, 33), (8192, 5)])
def test_ntt4_on_cuda_matches_cpu_and_host_butterfly(cuda, n, bsz):
    q = find_ntt_primes(n, 30, 1)[0]
    tb = build_ntt4_tables(q, n)
    x = np.random.default_rng(n).integers(0, 2 * q - 1, (bsz, n))
    before = k2.ntt4_transform.launches
    fwd = ntt4(torch.from_numpy(x).to(cuda), tb)
    back = intt4(fwd, tb)
    torch.cuda.synchronize()
    assert k2.ntt4_transform.launches == before + 2
    assert torch.equal(fwd.cpu(), ntt4(torch.from_numpy(x), tb))
    perm, _ = fourstep_perm(tb)
    host = hostntt.ntt(x % q, hostntt.build_tables(q, n))
    np.testing.assert_array_equal(fwd.cpu().numpy(), host[:, perm])
    np.testing.assert_array_equal(back.cpu().numpy(), x % q)


def test_ntt4_transform_kernel_rejects_what_it_cannot_take(cuda):
    q = find_ntt_primes(4096, 30, 1)[0]
    tb = build_ntt4_tables(q, 4096)
    x = torch.zeros((2, 4096), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32 or int64"):
        k2.ntt4_transform(x.short(), tb, False)
    with pytest.raises(ValueError, match="contiguous"):
        k2.ntt4_transform(x.reshape(4, 2048), tb, False)
    with pytest.raises(ValueError, match="non-empty"):
        k2.ntt4_transform(x[:0], tb, True)
    q256 = find_ntt_primes(256, 30, 1)[0]
    small = build_ntt4_tables(q256, 256)          # 16 x 16: no served ring
    with pytest.raises(ValueError, match="64 x n2"):
        k2.ntt4_transform(torch.zeros((1, 256), dtype=torch.int32,
                                      device=cuda), small, False)


@pytest.mark.parametrize("mode", ["full", "q1"])
def test_he_service_on_cuda_matches_cpu(cuda, mode):
    """The encrypted re-rank program on the card (through K2) against the
    same program on the CPU (through K2's plain version) and the numpy
    twin, at the default ring (N=4096, 2 limbs), d=128."""
    he = HEParams(sparse_h=32 if mode == "q1" else None)
    client = HEClient(he, seed=4)
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (500, 128)).astype(np.float32)
    q = rng.integers(0, 256, (3, 128)).astype(np.float32)
    cand = rng.integers(0, 500, (3, 40))
    gpu = HEComputeService(client.params, device=cuda)
    cpu = HEComputeService(client.params, device="cpu")
    for s in (gpu, cpu):
        s.set_base(base)
    cts = [cpu.ctx.ct_from_wire(w) for w in client.encrypt_query_batch(q)]
    before = k2.ntt4_transform.launches
    if mode == "full":
        rg = gpu.encrypted_scores_trunc(cts, cand)
        rc = cpu.encrypted_scores_trunc(cts, cand)
        got = client.decrypt_scores_trunc(*rg, q)
        per_limb = 2                 # transforms: forward, inverse of c0
    else:
        rg = gpu.encrypted_scores_trunc_q1(cts, cand)
        rc = cpu.encrypted_scores_trunc_q1(cts, cand)
        got = client.decrypt_scores_trunc_q1(*rg, q)
        per_limb = 3                 # and the inverse of c1
    assert k2.ntt4_transform.launches == before + 2 * per_limb
    for a, b in zip(rg, rc):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        got, ((base[cand] - q[:, None]) ** 2).sum(-1))


def test_threefry_on_cuda_matches_numpy(cuda):
    """The device form of tf_uniform_rns (int64 arithmetic on the card)
    bit-equal to the host numpy form, all-zero and all-ones keys among 64."""
    qs = find_ntt_primes(4096, 30, 2)
    keys = np.random.default_rng(3).integers(0, 1 << 32, (64, 2),
                                             dtype=np.uint32)
    keys[0], keys[1] = 0, (1 << 32) - 1
    got = tf_uniform_rns(torch.from_numpy(keys.astype(np.int64)).to(cuda),
                         qs, 4096).cpu().numpy()
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(got[i], t_bfv.tf_uniform_rns(k, qs,
                                                                   4096))


@pytest.mark.parametrize("entry", ["host", "seedTf"])
def test_packed_service_on_cuda_matches_cpu(cuda, entry):
    """The packed program on the card (every transform one K2 launch)
    against the same program on the CPU and the numpy twin, bit for bit, at
    the operating point (N=4096, 2 limbs, t = 2^24 + 1, d=128, P=256, G=16)
    with nq = 17: two response cts, the second holding one query."""
    client = HEClient(HEParams(resp_mod="packed"), seed=6)
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (900, 128)).astype(np.float32)
    q = rng.integers(0, 256, (17, 128)).astype(np.float32)
    cand = np.stack([rng.permutation(900)[:256] for _ in range(17)])
    gks = client.bfv_extraction_keys_wire(128)
    gpu = HEComputeService(client.params, device=cuda)
    cpu = HEComputeService(client.params, device="cpu")
    for s in (gpu, cpu):
        s.set_base(base)
        s.register_galois_keys("k", gks)
    wires = client.encrypt_query_batch(q)
    cts = [cpu.ctx.ct_from_wire(w) for w in wires]
    before = k2.ntt4_transform.launches
    if entry == "host":
        rg = gpu.encrypted_scores_packed(cts, cand, "k")
        want = 50
    else:
        rg = gpu.encrypted_scores_packed_wire(wires, cand, "k")
        want = 52
    assert k2.ntt4_transform.launches == before + want
    rc = cpu.encrypted_scores_packed(cts, cand, "k")
    assert rg[2] == rc[2] == 16 and len(rg[0]) == len(rc[0]) == 2
    ctq, pad_idx, _ = cpu.prepare(cts, cand)
    twin = cpu._packed_mac_numpy(ctq, pad_idx, cpu._galois_bfv["k"])
    for i, (a, b) in enumerate(zip(rg[0], rc[0])):
        for comp, x, y in ((0, a.c0, b.c0), (1, a.c1, b.c1)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, twin[i, comp])
    got = client.decrypt_scores_packed([c.to_wire() for c in rg[0]], rg[1],
                                       q, rg[2])
    np.testing.assert_array_equal(
        got, ((base[cand] - q[:, None]) ** 2).sum(-1))


@pytest.mark.parametrize("rows", [2048, 128])
def test_ntt4_transform_kernel_at_the_ckks_primes(cuda, rows):
    """K2 at N=8192 on the CKKS chain and its special prime
    (find_ntt_primes(8192, 30, 4)), at the combined program's largest row
    count (the pre-combine key switch, 512 rows x 4 digits) and a small
    one: forward of 15-bit digits and of residues, inverse of residues,
    exact against the plain version."""
    for q in find_ntt_primes(8192, 30, 4):
        tb = build_ntt4_tables(q, 8192)
        gen = torch.Generator(device=cuda).manual_seed(q % 1000)
        for hi, inverse in ((1 << 15, False), (q, False), (q, True)):
            x = torch.randint(0, hi, (rows, 8192), generator=gen,
                              device=cuda, dtype=torch.int64)
            before = k2.ntt4_transform.launches
            got = k2.ntt4_transform(x, tb, inverse)
            torch.cuda.synchronize()
            assert k2.ntt4_transform.launches == before + 1
            assert torch.equal(got, transform_plain(x, tb, inverse))


@pytest.mark.parametrize("shape", ["multi-row key switch",
                                   "single-row key switch", "database"])
def test_ntt4_transform_kernel_at_the_pir_shapes(cuda, shape):
    """K2 at the widest shapes the PIR path gives it at the SIFT1M preset
    (N=4096, find_ntt_primes(4096, 30, 2) and the special prime): the
    multi-row key switch's last round over the 100-row fetch's 10 cts
    (40,960 expanded cts in one program), forward of [163,840, 4,096]
    int32 15-bit digits and inverse of [81,920] int64 residues per
    extension prime; the 4-row single-row batch's, [8,192] and [4,096];
    the packed database, forward of [31,329, 4,096] int32 values below
    t=257 per limb. Exact against the plain version, compared in slices
    of 16,384 rows."""
    from prefhetch_tpu_torch.crypto.bfv import BFVContext
    from prefhetch_tpu_torch.crypto.params import pir_params_for

    p = pir_params_for(4096, 257, 2)
    if shape == "database":
        primes = p.qs
        cases = ((31329, 257, torch.int32, False),)
    else:
        primes = tuple(p.qs) + (BFVContext(p)._special_p,)
        cts = 40960 if shape == "multi-row key switch" else 2048
        cases = ((4 * cts, 1 << 15, torch.int32, False),
                 (2 * cts, None, torch.int64, True))
    for q in primes:
        tb = build_ntt4_tables(q, 4096)
        gen = torch.Generator(device=cuda).manual_seed(q % 1000)
        for rows, hi, dtype, inverse in cases:
            x = torch.randint(0, hi or q, (rows, 4096), generator=gen,
                              device=cuda, dtype=dtype)
            before = k2.ntt4_transform.launches
            got = k2.ntt4_transform(x, tb, inverse)
            torch.cuda.synchronize()
            assert k2.ntt4_transform.launches == before + 1
            for i in range(0, rows, 16384):
                assert torch.equal(got[i:i + 16384], transform_plain(
                    x[i:i + 16384], tb, inverse))
            del x, got


def test_pir_device_on_cuda_matches_cpu(cuda):
    """DevicePIR2 at N=4096, t=257, nbase 5,000, d=128: the packed
    database, a single-row batch and a 3-row multi-row answer on the card
    are bit-equal to the same program on the CPU, and decode exactly."""
    from prefhetch_tpu_torch.crypto.params import pir_params_for
    from prefhetch_tpu_torch.crypto.pir import PIRClient
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

    p = pir_params_for(4096, 257, 2)
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (5000, 128)).astype(np.float32)
    client = PIRClient(p, seed=5)
    gw = client.galois_keys_wire_2d_multi(5000, 128, 3)
    dev, cpu = (DevicePIR2(base, p, device=d) for d in (cuda, "cpu"))
    assert torch.equal(dev.db.cpu(), cpu.db)
    for svc in (dev, cpu):
        svc.register_galois_keys("k", gw)
    rows = [0, 4999, 1234]
    wires, rs = zip(*(client.build_query_2d(r, 5000, 128) for r in rows))
    before = k2.ntt4_transform.launches
    got = dev.answer_2d_batch(list(wires), "k")
    assert k2.ntt4_transform.launches - before == 6 * dev.logm + 8
    assert got == cpu.answer_2d_batch(list(wires), "k")
    wm, rm = client.build_query_2d_multi(rows, 5000, 128)
    multi = dev.answer_2d_multi(wm, "k", 3)
    assert multi == cpu.answer_2d_multi(wm, "k", 3)
    for row, resp, r in zip(rows * 2, got + multi, list(rs) + rm):
        np.testing.assert_array_equal(
            client.decode_response_2d(resp, 128, r), base[row])


def test_pir_device_needs_cuda(monkeypatch):
    """A CPU test: DevicePIR2 asked for the card without CUDA raises
    instead of running on the CPU."""
    from prefhetch_tpu_torch.crypto.params import pir_params_for
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = np.zeros((300, 32), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePIR2(base, pir_params_for(256, 257, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePIR2(base, pir_params_for(256, 257, 2), device="cuda")


@pytest.mark.parametrize("mode", ["combined", "per-block"])
def test_ckks_device_on_cuda_matches_cpu(cuda, mode):
    """DeviceCKKS on the card (every transform one K2 launch) bit-equal to
    the same program on the CPU, at config 3 (N=8192, 3 limbs, scale 2^26,
    d=128, P=256), nq = 2, host encode, seedTf wires for "combined":
    56 K2 launches a combined program, 48 a per-block one."""
    from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS

    he = HEParams(scheme="ckks", n=8192, n_limbs=3, scale_bits=26,
                  resp_mod="combined" if mode == "combined" else "full")
    client = HEClient(he, seed=12)
    wire = client.galois_keys_wire(128, client.combine_blocks(256, 128))
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 256, (2, 256, 128)).astype(np.float64)
    q = rng.integers(0, 256, (2, 128)).astype(np.float64)
    wires = client.encrypt_query_batch(q)
    gpu = DeviceCKKS(client.params, device=cuda)
    cpu = DeviceCKKS(client.params, device="cpu")
    for s in (gpu, cpu):
        s.register_keys("k", wire)
    before = k2.ntt4_transform.launches
    if mode == "combined":
        rg = gpu.encrypted_scores_combined_batch(wires, rows, "k")
        torch.cuda.synchronize()
        launched = k2.ntt4_transform.launches - before
        rc = cpu.encrypted_scores_combined_batch(wires, rows, "k")
        pairs = list(zip(rg[0], rc[0]))
        got = client.decrypt_scores_combined([c.to_wire() for c in rg[0]],
                                             rg[1], q)
    else:
        cts = [client.ctx.ct_from_wire(w) for w in wires]
        rg = gpu.encrypted_scores_batch(cts, rows, "k")
        torch.cuda.synchronize()
        launched = k2.ntt4_transform.launches - before
        rc = cpu.encrypted_scores_batch(cts, rows, "k")
        pairs = [p for a, b in zip(rg[0], rc[0]) for p in zip(a, b)]
        got = client.decrypt_scores_batch(
            [[c.to_wire() for c in per_q] for per_q in rg[0]], rg[1], q)
    assert launched == (56 if mode == "combined" else 48)
    for a, b in pairs:
        assert a.level == b.level and a.scale == b.scale
        np.testing.assert_array_equal(a.c0, b.c0)
        np.testing.assert_array_equal(a.c1, b.c1)
    np.testing.assert_array_equal(rg[1], rc[1])
    ref = ((rows - q[:, None]) ** 2).sum(-1)
    assert np.abs(got - ref).max() / ref.max() <= 0.01


PAD = 3.4e38


def _slab_inputs(dev, T, d, nq, max_t, dtype, seed):
    """Tiles of size T, 1, T−1, 0, T//2 and the empty tile; probe rows mixing
    them, the last row nothing but the empty tile."""
    rng = np.random.default_rng(seed)
    sizes = np.array([T, 1, T - 1, 0, T // 2, 0], np.int32)
    if dtype == torch.uint8:
        x = rng.integers(0, 256, (6, T, d)).astype(np.uint8)
    else:
        x = rng.normal(scale=40.0, size=(6, T, d)).astype(np.float32)
    for i, s in enumerate(sizes):
        x[i, s:] = 0
    payload = torch.from_numpy(x).to(dev, dtype)
    q = torch.from_numpy(
        rng.normal(scale=40.0, size=(nq, d)).astype(np.float32)).to(dev)
    probes = rng.integers(0, 6, (nq, max_t)).astype(np.int32)
    probes[0, :4] = [0, 1, 2, 3]
    probes[-1] = 5
    return (payload, torch.from_numpy(sizes).to(dev), q,
            torch.from_numpy(probes).to(dev))


def _assert_slab_equal(got, want, q, norms):
    """Same PAD lanes; valid lanes within the f32 summation error of the
    three terms, 1e-5·(‖q‖² + max‖x‖²)."""
    pad = want >= PAD / 2
    assert torch.equal(got >= PAD / 2, pad)
    tol = 1e-5 * ((q * q).sum(-1)[:, None] + norms.max())
    err = torch.where(pad, torch.zeros_like(got), (got - want).abs())
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.parametrize("T,d,nq,max_t,dtype", [
    (1024, 128, 64, 24, torch.bfloat16),      # the operating point's widths
    (100, 200, 5, 4, torch.float32),          # d past one pass of a warp
    (64, 32, 7, 5, torch.bfloat16),
])
def test_slab_distances_kernel_matches_plain(cuda, T, d, nq, max_t, dtype):
    payload, sizes, q, probes = _slab_inputs(cuda, T, d, nq, max_t, dtype,
                                             seed=T + d)
    norms = (payload.float() ** 2).sum(-1).contiguous()
    before = k45.slab_distances.launches
    got = k45.slab_distances(payload, norms, sizes, q, probes)
    torch.cuda.synchronize()
    assert k45.slab_distances.launches == before + 1
    want = k45.slab_distances_plain(payload, norms, sizes, q, probes)
    assert got.shape == (nq, max_t * T) and got.dtype == torch.float32
    _assert_slab_equal(got, want, q, norms)
    assert bool((got[-1] == PAD).all())


@pytest.mark.parametrize("T,d,nq,max_t", [
    (1024, 128, 64, 24), (100, 48, 5, 4), (64, 32, 7, 5),
])
def test_slab_distances_sq8_kernel_matches_plain(cuda, T, d, nq, max_t):
    codes, sizes, q, probes = _slab_inputs(cuda, T, d, nq, max_t,
                                           torch.uint8, seed=T + d + 1)
    q = q.abs() * 3
    g = torch.Generator().manual_seed(T)
    vmin = (torch.rand(d, generator=g) * 10 - 5).to(cuda)
    scale = (torch.rand(d, generator=g) * 0.8 + 0.2).to(cuda)
    norms = ((vmin + (codes.float() + 0.5) * scale) ** 2).sum(-1).contiguous()
    before = k45.slab_distances_sq8.launches
    got = k45.slab_distances_sq8(codes, norms, sizes, vmin, scale, q, probes)
    torch.cuda.synchronize()
    assert k45.slab_distances_sq8.launches == before + 1
    want = k45.slab_distances_sq8_plain(codes, norms, sizes, vmin, scale, q,
                                        probes)
    _assert_slab_equal(got, want, q, norms)


@pytest.mark.parametrize("case", ["all queries", "size-0 only", "twice"])
def test_slab_distances_sq8_kernel_schedule_cases(cuda, case):
    """K4's tile-major schedule at its hard cases: one tile probed by every
    query (a run over several chunks), nothing but size-0 tiles, a query
    probing one tile twice."""
    codes, sizes, q, probes = _slab_inputs(cuda, 256, 128, 64, 8,
                                           torch.uint8, seed=11)
    q = q.abs() * 3
    g = torch.Generator().manual_seed(11)
    vmin = (torch.rand(128, generator=g) * 10 - 5).to(cuda)
    scale = (torch.rand(128, generator=g) * 0.8 + 0.2).to(cuda)
    norms = ((vmin + (codes.float() + 0.5) * scale) ** 2).sum(-1).contiguous()
    if case == "all queries":
        probes[:, 0] = 0
    elif case == "size-0 only":
        probes[:] = 3
        probes[:, ::2] = 5
    else:
        probes[1, 1:3] = 2
    got = k45.slab_distances_sq8(codes, norms, sizes, vmin, scale, q, probes)
    torch.cuda.synchronize()
    want = k45.slab_distances_sq8_plain(codes, norms, sizes, vmin, scale, q,
                                        probes)
    _assert_slab_equal(got, want, q, norms)
    if case == "size-0 only":
        assert bool((got == PAD).all())


@pytest.mark.parametrize("case", ["all queries", "size-0 only", "twice"])
@pytest.mark.parametrize("T,d,dtype", [
    (1024, 128, torch.bfloat16), (100, 200, torch.float32),
])
def test_slab_distances_kernel_schedule_cases(cuda, case, T, d, dtype):
    """K5's pieces at the schedule's hard cases: one tile probed by every
    query (a run of 64 pairs cut into pieces), nothing but size-0 tiles
    (all PAD, no payload read), a query probing one tile twice; bf16 on the
    tensor cores, f32 on the FMA body."""
    payload, sizes, q, probes = _slab_inputs(cuda, T, d, 64, 8, dtype,
                                             seed=12)
    norms = (payload.float() ** 2).sum(-1).contiguous()
    if case == "all queries":
        probes[:, 0] = 0
    elif case == "size-0 only":
        probes[:] = 3
        probes[:, ::2] = 5
    else:
        probes[1, 1:3] = 2
    before = (k45.slab_distances.launches, k45.tile_schedule.launches)
    got = k45.slab_distances(payload, norms, sizes, q, probes)
    torch.cuda.synchronize()
    assert (k45.slab_distances.launches, k45.tile_schedule.launches) == (
        before[0] + 1, before[1] + 1)
    want = k45.slab_distances_plain(payload, norms, sizes, q, probes)
    _assert_slab_equal(got, want, q, norms)
    if case == "size-0 only":
        assert bool((got == PAD).all())


@pytest.mark.parametrize("case", [
    "random", "all queries", "size-0 only", "int32 keys", "one pair",
    "path batch", "8,192 pairs",
])
@pytest.mark.parametrize("chunk", [0, 4])
def test_tile_schedule_kernel_equals_stable_sort(cuda, case, chunk):
    """The schedule kernel against torch.sort(stable=True) on the card, bit
    for bit, and its piece list against the plain one: random ids, a tile
    probed by every query, a batch of empty tiles only, ids past int16
    (int32 keys, counts in global scratch), one pair, a batch of the path's
    shape over a preset view's 1,474 tiles, and more pairs than the kernel
    stages in shared memory."""
    rng = np.random.default_rng(len(case) + chunk)
    n_tiles = 6
    if case == "random":
        p = rng.integers(0, n_tiles, (70, 5))
    elif case == "all queries":
        p = rng.integers(0, n_tiles, (64, 8))
        p[:, 0] = 0
    elif case == "size-0 only":
        p = np.full((64, 8), 5)
        p[:, ::2] = 3
    elif case == "int32 keys":
        n_tiles = 40000
        p = rng.integers(0, n_tiles, (64, 48))
        p[:, :3] = 39999
    elif case == "one pair":
        p = np.array([[2]])
    elif case == "8,192 pairs":                 # past the staged pairs
        n_tiles = 1474
        p = rng.integers(0, n_tiles, (128, 64))
    else:
        n_tiles = 1474
        p = rng.zipf(1.3, (64, 48)) % (n_tiles - 1)
        p[:, 40:] = n_tiles - 1
    probes = torch.from_numpy(p.astype(np.int32)).to(cuda)
    before = k45.tile_schedule.launches
    got = k45.tile_schedule(probes, n_tiles, chunk)
    torch.cuda.synchronize()
    assert k45.tile_schedule.launches == before + 1
    want = k45.tile_schedule_plain(probes, n_tiles, chunk)
    ref = torch.sort(probes.reshape(-1).to(want[0].dtype), stable=True)
    assert got[0].dtype == ref.values.dtype
    assert torch.equal(got[0], ref.values)
    assert torch.equal(got[1], ref.indices)
    if chunk:
        n = int(want[2][0])
        assert torch.equal(got[2][:1 + 2 * n], want[2][:1 + 2 * n])


def test_slab_kernels_reject_what_they_cannot_take(cuda):
    payload, sizes, q, probes = _slab_inputs(cuda, 64, 32, 4, 4,
                                             torch.bfloat16, seed=2)
    norms = (payload.float() ** 2).sum(-1).contiguous()
    with pytest.raises(ValueError, match="int32"):
        k45.slab_distances(payload, norms, sizes, q, probes.long())
    with pytest.raises(ValueError, match="one of"):
        k45.slab_distances(payload.half(), norms, sizes, q, probes)
    with pytest.raises(ValueError, match="divisible by 8"):
        k45.slab_distances(payload[..., :12].contiguous(), norms, sizes,
                           q[:, :12].contiguous(), probes)
    with pytest.raises(ValueError, match="is on"):
        k45.slab_distances(payload, norms.cpu(), sizes, q, probes)
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros((6, 64, 440), device=cuda)
        k45.slab_distances(wide, norms, sizes,
                           torch.zeros((4, 440), device=cuda), probes)
    codes = torch.zeros((6, 64, 24), dtype=torch.uint8, device=cuda)
    aff = torch.ones(24, device=cuda)
    with pytest.raises(ValueError, match="divisible by 16"):
        k45.slab_distances_sq8(codes, norms, sizes, aff, aff,
                               q[:, :24].contiguous(), probes)


def _pq_probed_inputs(dev, T, M, ksub, nq, seed):
    """Tiles of sizes T, 1, T−1, 0, ... and the empty tile 9; four lists;
    probe rows mixing them, the last one nothing but the empty tile."""
    rng = np.random.default_rng(seed)
    ntiles, nlist = 9, 4
    codes = rng.integers(0, ksub, (ntiles + 1, T, M)).astype(np.uint8)
    codes[-1] = 0
    sizes = np.array([T, 1, T - 1, 0, T // 2, T, 3, T, 2, 0], np.int32)
    lutq = (rng.normal(size=(nq, M * ksub)) * 3000).astype(np.float32)
    lutp = (rng.normal(size=(nlist, M * ksub)) * 700).astype(np.float32)
    cadd = (rng.normal(size=(nq, nlist)) * 3000 * M ** 0.5).astype(np.float32)
    tile_list = np.sort(rng.integers(0, nlist, ntiles + 1)).astype(np.int32)
    tiles = rng.integers(0, ntiles + 1, (nq, 11)).astype(np.int32)
    tiles[0, :4] = [0, 1, 2, 3]
    tiles[-1] = ntiles
    return [torch.from_numpy(a).to(dev) for a in
            (codes, lutq, lutp, cadd, sizes, tile_list, tiles)]


@pytest.mark.parametrize("T,M,ksub,nq", [
    (256, 32, 256, 64),         # the operating point's widths
    (256, 32, 256, 13),
    (100, 8, 256, 5),           # M not a multiple of 16: byte loads
    (100, 64, 256, 13),         # a 32 KB table
    (64, 128, 256, 5),          # 64 KB
    (64, 200, 256, 3),          # 100 KB, byte loads
    (64, 16, 64, 3),
])
def test_pq_onehot_kernel_matches_plain(cuda, T, M, ksub, nq):
    """K3 (pq_probed_distances) against its plain version."""
    args = _pq_probed_inputs(cuda, T, M, ksub, nq, seed=T + M + nq)
    before = k3.pq_probed_distances.launches
    got = k3.pq_probed_distances(*args)
    torch.cuda.synchronize()
    assert k3.pq_probed_distances.launches == before + 1
    want = k3.pq_probed_distances_plain(*args)
    assert got.shape == (nq, 11 * T) and got.dtype == torch.float32
    pad = want >= PAD / 2
    assert torch.equal(got >= PAD / 2, pad)
    assert bool((got[-1] == PAD).all())
    # the bf16 table sums round the same way on both sides; the M terms are
    # added in f32 in another order: 1e-5·(Σ|terms| + |cadd|)
    lutq, lutp, cadd = args[1], args[2], args[3]
    tol = 1e-5 * (M * float(lutq.abs().max() + lutp.abs().max())
                  + float(cadd.abs().max()))
    err = torch.where(pad, torch.zeros_like(got), (got - want).abs())
    assert float(err.max()) <= tol


def test_pq_onehot_kernel_rejects_what_it_cannot_take(cuda):
    args = _pq_probed_inputs(cuda, 8, 4, 16, 2, seed=0)
    codes, lutq, lutp, cadd, sizes, tl, tiles = args
    with pytest.raises(ValueError, match="uint8"):
        k3.pq_probed_distances(codes.int(), *args[1:])
    with pytest.raises(ValueError, match="int32"):
        k3.pq_probed_distances(*args[:6], tiles.long())
    wide = torch.zeros((10, 8, 512), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="exceeds the shared"):
        k3.pq_probed_distances(
            wide, torch.zeros((2, 512 * 256), device=cuda),
            torch.zeros((4, 512 * 256), device=cuda), cadd, sizes, tl, tiles)
    with pytest.raises(ValueError, match="is on"):
        k3.pq_probed_distances(codes, lutq.cpu(), *args[2:])


@pytest.mark.parametrize("quant,scan,kernel", [
    ("pq", "union", "pq"), ("sq8", "union", "sq8"), ("none", "slab", "slab"),
    ("none", "union", "union_min"),
])
def test_query_pipeline_on_cuda_matches_cpu(cuda, quant, scan, kernel):
    """Each scan variant on the card (through its kernel) against the same
    variant on the CPU (through the plain version), same index: the exact
    re-rank makes the final distances equal; ids as sets (ties)."""
    data = make_clustered_dataset(nbase=2048, ntrain=4000, nquery=8, d=32,
                                  n_clusters=40, gt_k=50, seed=9)
    params = IndexParams(d=32, nlist=16, pq_m=8, pq_nbits=8, kmeans_iters=8,
                         pq_kmeans_iters=8)
    cpu_idx = build_ivf_index(data["train"], data["base"], params,
                              device="cpu")
    arrays = {
        "centroids": cpu_idx.centroids.numpy(),
        "list_ids": cpu_idx.list_ids.numpy(),
        "list_sizes": cpu_idx.list_sizes.numpy(),
        "list_norms": cpu_idx.list_norms.numpy(),
        "list_codes": cpu_idx.list_codes.numpy(),
        "codebooks": cpu_idx.codebooks.numpy(),
        "list_recon_bf16": cpu_idx.host_arrays["payload"],
    }
    counters = {
        "pq": k3.pq_probed_distances, "sq8": k45.slab_distances_sq8,
        "slab": k45.slab_distances, "union_min": usm.union_scan_min,
    }
    out = {}
    for dev, idx in (("cpu", cpu_idx),
                     (cuda, index_from_numpy(arrays, params, cuda))):
        before = {n: f.launches for n, f in counters.items()}
        step, args, stats = query_pipeline(
            idx, data["base"], data["query"], nprobe=6, coarse_probe=40,
            k=10, quant=quant, scan=scan, tile=64, prune_j=4, device=dev)
        d, ids = step(*args)
        delta = {n: f.launches - before[n] for n, f in counters.items()}
        want = {n: int(dev != "cpu" and n == kernel) for n in counters}
        assert delta == want
        out[str(dev)[:3]] = (d.cpu().numpy(), ids.cpu().numpy())
    np.testing.assert_array_equal(out["cud"][0], out["cpu"][0])
    for r in range(8):
        assert set(out["cud"][1][r]) == set(out["cpu"][1][r])


def test_native_frontend_on_cuda(cuda, monkeypatch):
    """The native epoll frontend over an engine on the card: concurrent
    one-query /search requests go through K1 once per wave's engine call
    and equal the in-process Dispatcher's answers; JSON /coarsesearch and
    /precisesearch over HTTP equal the in-process Dispatcher's."""
    import http.client
    import json
    from concurrent.futures import ThreadPoolExecutor

    from prefhetch_tpu_torch.serve.handlers import Dispatcher
    from prefhetch_tpu_torch.serve.native_server import serve_forever_native
    from prefhetch_tpu_torch.utils import wire_bin

    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    data = make_clustered_dataset(nbase=4096, ntrain=4000, nquery=32, d=32,
                                  n_clusters=40, gt_k=50, seed=9)
    cfg = PipelineConfig(
        index=IndexParams(d=32, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=6, coarse_probe=40, k=10, nquery=4),
        nbase=4096,
    )
    engine = QueryEngine(cfg, device=cuda)
    engine.serve_tile = 64
    engine.set_index(build_ivf_index(data["train"], data["base"], cfg.index,
                                     device=cuda), data["base"])
    q = data["query"].astype(np.float32)
    cents = engine.retrieve_centroids()
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6].astype(np.int64)
    disp = Dispatcher(engine)
    bin_hdr = {"content-type": wire_bin.CONTENT_TYPE}
    reqs = [wire_bin.encode(wire_bin.KIND_SEARCH_REQ, [
        q[i:i + 1], probes[i:i + 1], np.array([10], np.uint32)])
        for i in range(len(q))]
    single = [wire_bin.decode(disp.handle("POST", "/search", bin_hdr, r)[2])
              for r in reqs]
    srv = serve_forever_native(engine, port=0, background=True,
                               max_batch=256, grace_ms=1.5, n_resolvers=3)

    def post(path, body, ctype):
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        try:
            c.request("POST", path, body=body,
                      headers={"Content-Type": ctype})
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    try:
        k1 = usm.union_scan_min.launches
        calls = srv.group_calls["fused"]
        order = list(range(len(q))) * 4
        with ThreadPoolExecutor(32) as ex:
            outs = list(ex.map(
                lambda i: post("/search", reqs[i], wire_bin.CONTENT_TYPE),
                order))
        for i, (status, body) in zip(order, outs):
            assert status == 200
            _, (ids, dists) = wire_bin.decode(body)
            np.testing.assert_allclose(dists, single[i][1][1], rtol=1e-5)
            assert set(ids[0]) == set(single[i][1][0][0])
        fused = srv.group_calls["fused"] - calls
        assert 1 <= fused <= len(order)
        assert usm.union_scan_min.launches - k1 == fused
        for path, body in (
            ("/coarsesearch", {"preciseQuery": q[:4].tolist(),
                               "nearestCentroidIndexes":
                                   probes[:4].tolist()}),
            ("/precisesearch", {"preciseQuery": q[:4].tolist(),
                                "nearestCoarseVectorIndexes":
                                    np.arange(160).reshape(4, 40).tolist()}),
        ):
            raw = json.dumps(body).encode()
            status, got = post(path, raw, "application/json")
            assert status == 200
            want = disp.handle("POST", path, {}, raw)[2]
            gj, wj = json.loads(got), json.loads(want)
            for key in wj:
                np.testing.assert_allclose(gj[key], wj[key], rtol=1e-6)
    finally:
        srv.shutdown()


def test_server_refuses_when_cuda_is_hidden(cuda):
    """Asked for the card on a machine where CUDA is not visible, the
    server exits with the reason instead of serving on the CPU."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=root)
    run = subprocess.run(
        [sys.executable, "-m", "prefhetch_tpu_torch.serve.main", "--port",
         "0", "--frontend", "threaded"],
        capture_output=True, env=env, cwd=root, timeout=120)
    assert run.returncode == 2
    assert b"torch.cuda.is_available() is False" in run.stderr


def _sharded_cuda_engines(cuda, k):
    """(unsharded, k-shard) engines on the card over one index (tile 64),
    the k shards all on ``cuda``; the queries and probes."""
    data = make_clustered_dataset(nbase=2048, ntrain=4000, nquery=8, d=32,
                                  n_clusters=40, gt_k=50, seed=9)
    cfg = PipelineConfig(
        index=IndexParams(d=32, nlist=16, pq_m=8, pq_nbits=8,
                          kmeans_iters=8, pq_kmeans_iters=8),
        protocol=ProtocolParams(nprobe=6, coarse_probe=40, k=10, nquery=4),
        nbase=2048,
    )
    idx = build_ivf_index(data["train"], data["base"], cfg.index,
                          device=cuda)
    engines = []
    for shards in (0, k):
        e = QueryEngine(cfg, device=cuda)
        e.serve_tile = 64
        e.set_index(idx, data["base"])
        if shards:
            e.enable_sharding(devices=[cuda] * shards)
        engines.append(e)
    q = data["query"][:4]
    cents = engines[0].retrieve_centroids()
    probes = np.argsort(((q[:, None] - cents[None]) ** 2).sum(-1), axis=1,
                        kind="stable")[:, :6]
    return engines, q, probes


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_engine_on_cuda_matches_unsharded(cuda, monkeypatch, k):
    """A mesh of k shards on the one card: every plaintext route of the
    sharded engine bit-equal to the unsharded engine on the card (the f32
    union scan multiplies a fixed number of tiles at a time, so a library
    product at a shard's shape cannot sum otherwise); the pruned fused
    route launches K1 once a shard."""
    monkeypatch.setenv("PFH_SERVE_PRUNE_J", "4")
    (plain, sharded), q, probes = _sharded_cuda_engines(cuda, k)
    for name, args in (("coarse_search", (q, probes)),
                       ("coarse_search_tiled", (q, probes)),
                       ("coarse_search_topk", (q, probes, 40)),
                       ("precise_search",
                        (q, np.arange(160).reshape(4, 40))),
                       ("precise_vector_pir",
                        (np.arange(24).reshape(4, 6),))):
        a, b = getattr(plain, name)(*args), getattr(sharded, name)(*args)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y, err_msg=name)
    want = plain.search_fused(q, probes, 10)
    before = usm.union_scan_min.launches
    got = sharded.search_fused(q, probes, 10)
    torch.cuda.synchronize()
    assert usm.union_scan_min.launches - before == k
    for x, y in zip(want, got):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [1, 4])
def test_sharded_encrypted_on_cuda_matches_one_device(cuda, k):
    """The q1 MAC query-sharded over k shards of the card (K2, 6 launches a
    shard) and the PIR answer with its database sharded (g1=8), at N=4096
    (the smallest ring K2 takes): bit-equal to one device and to the numpy
    twin."""
    from prefhetch_tpu_torch.crypto.params import pir_params_for
    from prefhetch_tpu_torch.crypto.pir import PIRClient
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2
    from prefhetch_tpu_torch.parallel.mesh import make_mesh
    from prefhetch_tpu_torch.parallel.sharded import (
        pad_rows_for_mesh, shard_rows, sharded_trunc_mac_q1,
    )

    mesh = make_mesh(devices=[cuda] * k)
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (400, 32)).astype(np.float32)
    queries = rng.integers(0, 256, (8, 32)).astype(np.float32)
    idx = np.stack([rng.permutation(400)[:32] for _ in range(8)])
    hc = HEClient(HEParams(n=4096, sparse_h=48, resp_mod="q1"), seed=5)
    svc = HEComputeService(hc.params, device=cuda)
    svc.set_base(base)
    ctq, pad_idx, _ = svc._prepare(
        [svc.ctx.ct_from_wire(w) for w in hc.encrypt_query_batch(queries)],
        idx)
    want = svc._trunc_mac_q1_numpy(ctq[:, 0], ctq[:, 1], pad_idx)
    before = k2.ntt4_transform.launches
    got = sharded_trunc_mac_q1(
        mesh, shard_rows(torch.from_numpy(pad_rows_for_mesh(
            svc._base_host, k)).to(cuda), mesh), ctq, pad_idx, svc.params)
    torch.cuda.synchronize()
    assert k2.ntt4_transform.launches - before == 6 * k
    np.testing.assert_array_equal(got.cpu().numpy(), want)

    p = pir_params_for(4096, 257, 2)
    pb = rng.integers(0, 256, (8192, 32)).astype(np.float32)     # g1 = 8
    cl = PIRClient(p, seed=9)
    dev = DevicePIR2(pb, p, device=cuda)
    assert dev.g1 == 8
    dev.register_galois_keys(cl.key_id, cl.galois_keys_wire_2d(8192, 32))
    w, r = cl.build_query_2d(301, 8192, 32)
    got = dev.answer_2d_sharded(w, cl.key_id, mesh)
    assert got == dev.answer_2d(w, cl.key_id)
    np.testing.assert_array_equal(cl.decode_response_2d(got, 32, r),
                                  pb[301].astype(np.int64))


def test_init_multihost_nccl_world_of_one(cuda):
    """NCCL refuses two ranks on one GPU: the card runs a world of one. Its
    mesh's collectives go through NCCL; shard_index_multihost holds the
    shards shard_index does; a sharded re-rank through the world equals the
    unsharded one."""
    import socket

    import torch.distributed as dist

    from prefhetch_tpu_torch.ops.rerank import exact_rerank
    from prefhetch_tpu_torch.parallel.multihost import (
        init_multihost, shard_array_global, shard_index_multihost,
        shutdown_multihost,
    )
    from prefhetch_tpu_torch.parallel.sharded import (
        shard_index, sharded_rerank,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = init_multihost(f"127.0.0.1:{port}", 1, 0, local_device_ids=[0])
    try:
        assert dist.get_backend() == "nccl" and mesh.ndev == 1
        data = make_clustered_dataset(nbase=2048, ntrain=4000, nquery=8,
                                      d=32, n_clusters=40, gt_k=50, seed=9)
        idx = build_ivf_index(
            data["train"], data["base"],
            IndexParams(d=32, nlist=16, pq_m=8, kmeans_iters=4,
                        pq_kmeans_iters=4), device=cuda)
        a, b = shard_index_multihost(idx, mesh), shard_index(idx, mesh)
        for sa, sb in zip(a.shards, b.shards):
            assert torch.equal(sa.list_ids, sb.list_ids)
        q = torch.from_numpy(data["query"]).to(cuda)
        cand = torch.arange(320, device=cuda).reshape(8, 40)
        got = sharded_rerank(mesh, shard_array_global(data["base"], mesh), q,
                             cand)
        want = exact_rerank(torch.from_numpy(data["base"]).to(cuda), q, cand)
        assert torch.equal(got, want)
    finally:
        shutdown_multihost()


def test_dryrun_multichip_on_cuda(cuda):
    from prefhetch_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device=cuda)
    assert out["ok"] and out["k1_pruned_scan"] == 4
    assert out["k2_q1_mac"] == 24
