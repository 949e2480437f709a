"""Port parity: the threefry-seeded query wire (``seedTf``) of the packed
BFV response against the JAX package.

- ``tf_uniform_rns``: the port's numpy form (crypto/bfv.py) and its torch
  form (ops/threefry.py, what the device program runs) are bit-equal to the
  JAX package's numpy and jnp forms;
- ``encrypt_symmetric_batch_ntt_tf`` wires from one seed are bit-equal;
- the packed program's seeded entry (c1 regenerated from the keys inside
  the program) is bit-equal, c0 and c1 of every output ciphertext, to the
  JAX package's numpy oracle and to its jitted seeded program, with nq a
  non-multiple of G and nq = G.

All integer: tolerance zero. The JAX service runs its jitted program
(``backend="tpu"``) on CPU JAX, as tests/test_bfv_packed.py does; the port
runs its torch program on CPU tensors, where K2's wrapper takes its plain
version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prefhetch_tpu.client.he import HEClient as JClient
from prefhetch_tpu.crypto import bfv as j_bfv
from prefhetch_tpu.engine.hecompute import HEComputeService as JService
from prefhetch_tpu.utils.config import HEParams as JHEParams
from prefhetch_tpu_torch.client.he import HEClient as TClient
from prefhetch_tpu_torch.crypto import bfv as t_bfv
from prefhetch_tpu_torch.crypto.params import bfv_params_for
from prefhetch_tpu_torch.engine.hecompute import HEComputeService as TService
from prefhetch_tpu_torch.ops import ntt4_fused, ntt4_step
from prefhetch_tpu_torch.ops.threefry import tf_uniform_rns
from prefhetch_tpu_torch.utils.config import HEParams as THEParams

torch.set_num_threads(1)

U32 = (1 << 32) - 1
KEYS = np.array([[0, 0], [U32, U32], [0, U32], [U32, 0], [1, 2],
                 [0x1BD11BDA, 0x1BD11BDA], [123456789, 987654321],
                 [1 << 31, (1 << 31) - 1]], np.uint32)


@pytest.mark.parametrize("n,n_limbs", [(256, 2), (4096, 2), (256, 3)])
def test_tf_uniform_rns_four_forms_bit_equal(n, n_limbs):
    """Port numpy = port torch (batched over keys) = JAX numpy = JAX jnp,
    canonical residues, over 8 fixed keys (the all-zero and all-ones keys
    among them) and 8 random ones."""
    qs = bfv_params_for(n, 24, n_limbs).qs
    rng = np.random.default_rng(n + n_limbs)
    keys = np.concatenate(
        [KEYS, rng.integers(0, 1 << 32, (8, 2), dtype=np.uint32)])
    dev = tf_uniform_rns(torch.from_numpy(keys.astype(np.int64)), qs, n)
    assert dev.dtype == torch.int64 and dev.shape == (16, n_limbs, n)
    for i, k in enumerate(keys):
        want = j_bfv.tf_uniform_rns(k, qs, n)
        np.testing.assert_array_equal(t_bfv.tf_uniform_rns(k, qs, n), want)
        np.testing.assert_array_equal(dev[i].numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(j_bfv.tf_uniform_rns(jnp.asarray(k), qs, n)), want)
    q = np.array(qs, np.int64)[None, :, None]
    assert (dev.numpy() >= 0).all() and (dev.numpy() < q).all()
    # int32 keys holding the top bit: their u32 value, not a negative one
    signed = torch.from_numpy(KEYS.view(np.int32))
    assert torch.equal(tf_uniform_rns(signed, qs, n), dev[:8])


def test_tf_wires_from_one_seed_and_their_expansion():
    """encrypt_symmetric_batch_ntt_tf: the same wires from one seed in both
    packages; ct_from_wire expands them to the same ciphertext; each
    package decrypts to the encoded query."""
    he = dict(n=256, resp_mod="packed")
    jc, tc = JClient(JHEParams(**he), seed=4), TClient(THEParams(**he), seed=4)
    q = np.random.default_rng(1).integers(0, 256, (3, 32)).astype(np.float64)
    wt, wj = tc.encrypt_query_batch(q), jc.encrypt_query_batch(q)
    assert wt == wj and all(set(w) == {"c0", "seedTf", "shape", "isNtt",
                                       "scheme"} for w in wt)
    for w in wt:
        ct_t, ct_j = tc.ctx.ct_from_wire(w), jc.ctx.ct_from_wire(w)
        np.testing.assert_array_equal(ct_t.c0, ct_j.c0)
        np.testing.assert_array_equal(ct_t.c1, ct_j.c1)
        np.testing.assert_array_equal(tc.ctx.decrypt(tc.sk, ct_t),
                                      jc.ctx.decrypt(jc.sk, ct_j))


# -- the packed program's seeded entry -----------------------------------------

N, D, P = 256, 32, 64                     # B = 8, nb = 8, G = 4


@pytest.fixture(scope="module")
def seeded_setup():
    he = dict(n=N, resp_mod="packed")
    jc = JClient(JHEParams(**he), seed=31)
    tc = TClient(THEParams(**he), seed=31)
    rng = np.random.default_rng(32)
    base = rng.integers(0, 256, (500, D)).astype(np.float32)
    gks = tc.bfv_extraction_keys_wire(D)
    assert gks == jc.bfv_extraction_keys_wire(D)
    ts = TService(tc.params, device="cpu")
    js = JService(jc.params, backend="tpu")          # jitted, on CPU
    jn = JService(jc.params, backend="numpy")        # the host oracle
    for s in (ts, js, jn):
        s.set_base(base)
        s.register_galois_keys("k", gks)
    return tc, ts, js, jn, base, rng


@pytest.mark.parametrize("nq", [5, 4])
def test_seeded_program_bit_equal_to_jax(seeded_setup, nq):
    tc, ts, js, jn, base, rng = seeded_setup
    q = rng.integers(0, 256, (nq, D)).astype(np.float64)
    cand = np.stack([rng.permutation(500)[:P] for _ in range(nq)])
    wires = tc.encrypt_query_batch(q)
    plain = ntt4_step.ntt4_step_plain.calls
    launches = ntt4_fused.ntt4_transform.launches
    pt, nt, gt = ts.encrypted_scores_packed_wire(wires, cand, "k")
    # K2 (plain on the CPU, 2 stages a transform): L per limb for the
    # seeded c1, 2L for the MAC, 2(L+1) a round over log2(32) = 5 rounds,
    # 2L for the pack
    assert ntt4_step.ntt4_step_plain.calls - plain == 2 * (2 + 4 + 30 + 4)
    assert ntt4_fused.ntt4_transform.launches == launches
    pj, nj, gj = js.encrypted_scores_packed_wire(wires, cand, "k")
    po, no, go = jn.encrypted_scores_packed_wire(wires, cand, "k")
    assert gt == gj == go == 4
    assert len(pt) == len(pj) == len(po) == -(-nq // 4)
    for a, b, c in zip(pt, pj, po):
        for comp in ("c0", "c1"):
            np.testing.assert_array_equal(getattr(a, comp), getattr(b, comp))
            np.testing.assert_array_equal(getattr(a, comp), getattr(c, comp))
    np.testing.assert_array_equal(nt, nj)
    got = tc.decrypt_scores_packed([c.to_wire() for c in pt], nt, q, gt)
    np.testing.assert_array_equal(
        got, ((base[cand].astype(np.float64) - q[:, None]) ** 2).sum(-1))


def test_seeded_wire_refusals(seeded_setup):
    tc, ts, js, jn, base, rng = seeded_setup
    q = rng.integers(0, 256, (2, D)).astype(np.float64)
    cand = rng.integers(0, 500, (2, P))
    wires = tc.encrypt_query_batch(q)
    for bad in ([-1, 2], [1 << 32, 0], [1, 2, 3]):
        w = [dict(wires[0], seedTf=bad), wires[1]]
        with pytest.raises(ValueError, match="seedTf"):
            ts.encrypted_scores_packed_wire(w, cand, "k")
    w = [dict(wires[0], c0=wires[0]["c0"][:-8]), wires[1]]
    with pytest.raises(ValueError):
        ts.encrypted_scores_packed_wire(w, cand, "k")
