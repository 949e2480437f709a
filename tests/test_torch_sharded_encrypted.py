"""Port parity: the mesh-sharded encrypted services — counterparts of
tests/test_sharded_encrypted.py.

``sharded_trunc_mac_q1`` (the BFV q1 MAC re-rank, base row-sharded, MAC
query-sharded) and ``DevicePIR2.answer_2d_sharded`` (the PIR database
sharded over the dim-1 fold) are exact integer arithmetic: every assertion
is exact equality, against the port's single-device program, the numpy
oracle and the JAX sharded function on the JAX suite's 8-device mesh, on
CPU meshes of 1, 2, 4 and 8 shards. Kernel K2's transforms are counted by
patching the name ops/ntt4 calls (the wrapper counts card launches). The
JAX refusals keep their texts."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from prefhetch_tpu.crypto.params import bfv_params_for as j_bfv_params
from prefhetch_tpu.crypto.params import pir_params_for as j_pir_params
from prefhetch_tpu.engine.pir_device import DevicePIR2 as JDevicePIR2
from prefhetch_tpu.parallel import sharded as J
from prefhetch_tpu.parallel.mesh import make_mesh as j_make_mesh
from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.crypto.params import pir_params_for
from prefhetch_tpu_torch.crypto.pir import PIRClient, grid_dims
from prefhetch_tpu_torch.engine.hecompute import HEComputeService
from prefhetch_tpu_torch.engine.pir_device import DevicePIR2
from prefhetch_tpu_torch.ops import ntt4 as ntt4_mod
from prefhetch_tpu_torch.parallel.mesh import make_mesh
from prefhetch_tpu_torch.parallel.sharded import (
    pad_rows_for_mesh, shard_rows, sharded_trunc_mac_q1,
)
from prefhetch_tpu_torch.utils.config import HEParams

torch.set_num_threads(1)

MESHES = [1, 2, 4, 8]


def _cpu_mesh(k):
    return make_mesh(devices=["cpu"] * k)


def _count_transforms(monkeypatch):
    calls = [0]
    real = ntt4_mod.ntt4_transform

    def counting(x, tb, inverse):
        calls[0] += 1
        return real(x, tb, inverse)

    monkeypatch.setattr(ntt4_mod, "ntt4_transform", counting)
    return calls


@pytest.fixture(scope="module")
def mac():
    """The JAX test's inputs: nbase 400, d=32, 8 queries, 32 candidates."""
    rng = np.random.default_rng(11)
    nbase, d, nq, pc = 400, 32, 8, 32
    base = rng.integers(0, 256, (nbase, d)).astype(np.float32)
    queries = rng.integers(0, 256, (nq, d)).astype(np.float32)
    idx = np.stack([rng.permutation(nbase)[:pc] for _ in range(nq)])
    hc = HEClient(HEParams(n=256, sparse_h=48, resp_mod="q1"), seed=5)
    svc = HEComputeService(hc.params, device="cpu")
    svc.set_base(base)
    cts = [svc.ctx.ct_from_wire(w) for w in hc.encrypt_query_batch(queries)]
    ctq, pad_idx, norms = svc._prepare(cts, idx)
    want = svc._trunc_mac_q1_numpy(ctq[:, 0], ctq[:, 1], pad_idx)
    return base, queries, idx, hc, svc, ctq, pad_idx, norms, want


@pytest.mark.parametrize("k", MESHES)
def test_sharded_trunc_mac_q1_bit_equal(mac, monkeypatch, k):
    """Row-sharded base + query-sharded MAC == the single-device q1 program
    and its numpy twin, bit for bit; K2 runs 6 transforms a shard (two
    limbs × one forward, two inverse); the client decrypts exact scores."""
    base, queries, idx, hc, svc, ctq, pad_idx, norms, want = mac
    one = svc._trunc_mac_q1(torch.from_numpy(ctq), torch.from_numpy(pad_idx))
    np.testing.assert_array_equal(one.numpy(), want)
    mesh = _cpu_mesh(k)
    calls = _count_transforms(monkeypatch)
    got = sharded_trunc_mac_q1(
        mesh, shard_rows(pad_rows_for_mesh(svc._base_host, k), mesh),
        ctq, pad_idx, svc.params)
    assert calls[0] == 6 * k
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    c1w, c0w, nrm = svc.trunc_unbundle_q1(got.numpy(), norms)
    out = hc.decrypt_scores_trunc_q1(c1w, c0w, nrm, queries)
    ref = ((base[idx].astype(np.float64) - queries[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_sharded_trunc_mac_q1_matches_jax(mac):
    """The port's sharded MAC against the JAX sharded_trunc_mac_q1 on the
    same ctq and indices, meshes of 8."""
    *_, svc, ctq, pad_idx, _, _ = mac
    p = svc.params
    jp = j_bfv_params(p.n, 24, 2)
    assert tuple(jp.qs) == tuple(p.qs) and jp.t == p.t
    jmesh = j_make_mesh(8)
    base_pad = pad_rows_for_mesh(svc._base_host, 8)
    jgot = J.sharded_trunc_mac_q1(
        jmesh, jax.device_put(base_pad, NamedSharding(jmesh, P("lists"))),
        ctq, pad_idx, jp)
    mesh = _cpu_mesh(8)
    got = sharded_trunc_mac_q1(mesh, shard_rows(base_pad, mesh), ctq,
                               pad_idx, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_sharded_trunc_mac_q1_refuses_indivisible_queries(mac):
    *_, svc, ctq, pad_idx, _, _ = mac
    mesh = _cpu_mesh(3)
    with pytest.raises(ValueError, match="nq=8 not divisible by 3 devices"):
        sharded_trunc_mac_q1(
            mesh, shard_rows(pad_rows_for_mesh(svc._base_host, 3), mesh),
            ctq, pad_idx, svc.params)


@pytest.fixture(scope="module")
def pir():
    """The JAX test's PIR inputs: nbase 512, d=32 (R=8, G=64, g1=8)."""
    p = pir_params_for(256, 257, 2)
    rng = np.random.default_rng(7)
    nbase, d = 512, 32
    assert grid_dims(p, nbase, d)[1] == 8
    base = rng.integers(0, 256, (nbase, d)).astype(np.float32)
    client = PIRClient(p, seed=9)
    dev = DevicePIR2(base, p, device="cpu")
    dev.register_galois_keys(client.key_id,
                             client.galois_keys_wire_2d(nbase, d))
    w, r = client.build_query_2d(301, nbase, d)
    return base, client, dev, w, r


@pytest.mark.parametrize("k", MESHES)
def test_sharded_pir_answer_bit_equal(pir, monkeypatch, k):
    """Database-sharded dim-1 fold == answer_2d, wire-exact, with as many K2
    transforms; the client decodes the exact row."""
    base, client, dev, w, r = pir
    calls = _count_transforms(monkeypatch)
    want = dev.answer_2d(w, client.key_id)
    n_one = calls[0]
    got = dev.answer_2d_sharded(w, client.key_id, _cpu_mesh(k))
    assert calls[0] == 2 * n_one
    assert got == want
    np.testing.assert_array_equal(client.decode_response_2d(got, 32, r),
                                  np.round(base[301]).astype(np.int64))


def test_sharded_pir_answer_matches_jax(pir):
    """The port's sharded answer against the JAX answer_2d_sharded on the
    JAX suite's 8-device mesh, the port client's wire and keys."""
    base, client, dev, w, _ = pir
    jdev = JDevicePIR2(base, j_pir_params(256, 257, 2))
    jdev.register_galois_keys("k", client.galois_keys_wire_2d(512, 32))
    jgot = jdev.answer_2d_sharded(w, "k", j_make_mesh(8))
    got = dev.answer_2d_sharded(w, client.key_id, _cpu_mesh(8))
    assert got == jgot


def test_sharded_pir_rejects_indivisible_grid(pir):
    """g1 not divisible by the mesh fails loudly, with the JAX text: g1=8
    against 3 shards, and the JAX test's g1=7 grid against 8."""
    _, client, dev, w, _ = pir
    with pytest.raises(ValueError, match="g1=8 not divisible by 3 devices"):
        dev.answer_2d_sharded(w, client.key_id, _cpu_mesh(3))
    p = pir_params_for(256, 257, 2)
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (300, 32)).astype(np.float32)
    cl = PIRClient(p, seed=3)
    dev7 = DevicePIR2(base, p, device="cpu")
    dev7.register_galois_keys(cl.key_id, cl.galois_keys_wire_2d(300, 32))
    w7, _ = cl.build_query_2d(5, 300, 32)
    with pytest.raises(ValueError, match="g1=7 not divisible by 8 devices"):
        dev7.answer_2d_sharded(w7, cl.key_id, _cpu_mesh(8))
