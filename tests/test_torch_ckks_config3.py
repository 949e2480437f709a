"""Port parity at BASELINE.json config 3's widths, on the CPU: CKKS N=8192,
3 limbs of ~30 bits plus the special prime, scale 2^26, d=128, P=256
candidates (32 a plaintext, 8 blocks), integer base rows in [0, 255], one
query. ``DeviceCKKS(device="cpu")`` runs its program on K2's plain version.

The host-encoded programs (combined and per-block) are bit-equal to the JAX
package's numpy ``CKKSComputeService``. The served form (parked-base
gather, f32 device encode) is bit-equal to the port's own row-upload
device encode; at this scale its f32 sum may round a coefficient to a
neighbouring integer, so it is held to the distances: max |error| over the
largest distance ≤ 0.01 (bench.py's ``ckks_max_rel_err``) for candidates
whose distances reach ~1e6 (random rows here, padded rows in bench.py).
The combined response's error is absolute (~5e3 on an inner product of
~2e6), so near candidates are held to that instead (the last test)."""

import numpy as np
import pytest
import torch

from prefhetch_tpu.crypto import ckks as J
from prefhetch_tpu.crypto.params import ckks_params_for as j_params
from prefhetch_tpu.engine.hecompute import CKKSComputeService as JService
from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.crypto import ckks as T
from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS
from prefhetch_tpu_torch.utils.config import HEParams

torch.set_num_threads(1)

N, D, P, LIMBS, SCALE_BITS = 8192, 128, 256, 3, 26
MAX_REL = 0.01


@pytest.fixture(scope="module")
def op():
    he = HEParams(scheme="ckks", n=N, n_limbs=LIMBS, scale_bits=SCALE_BITS,
                  resp_mod="combined")
    client = HEClient(he, seed=23)
    nb = client.combine_blocks(P, D)
    assert nb == 8
    wire = client.galois_keys_wire(D, nb)
    assert len(wire) == 10                   # 7 IP-tree + 3 combine steps
    rng = np.random.default_rng(24)
    base = rng.integers(0, 256, (3000, D)).astype(np.float32)
    q = rng.integers(0, 256, (1, D)).astype(np.float64)
    ids = rng.permutation(3000)[:P][None].astype(np.int32)
    js = JService(j_params(N, SCALE_BITS, LIMBS))
    js.register_keys("k", wire)
    dev = DeviceCKKS(client.params, device="cpu")
    dev.register_keys("k", wire)
    return client, js, dev, base, q, ids


def _max_rel(dists, base, ids, q):
    ref = ((base[ids[0]].astype(np.float64) - q[0]) ** 2).sum(-1)
    return float(np.abs(dists[0] - ref).max() / ref.max())


def test_config3_combined_bit_equal_to_jax_and_accurate(op):
    client, js, dev, base, q, ids = op
    w = client.encrypt_query_batch(q)[0]
    assert "seedTf" in w and w["level"] == LIMBS
    rows = base[ids].astype(np.float64)
    h_ct, h_norms = js.encrypted_scores_combined(
        J.CKKSContext(js.params).ct_from_wire(w), rows[0], "k")
    d_cts, d_norms = dev.encrypted_scores_combined_batch([w], rows, "k")
    assert d_cts[0].level == h_ct.level == 1
    assert abs(d_cts[0].scale - h_ct.scale) <= 1e-6 * abs(h_ct.scale)
    np.testing.assert_array_equal(d_cts[0].c0, h_ct.c0)
    np.testing.assert_array_equal(d_cts[0].c1, h_ct.c1)
    np.testing.assert_array_equal(d_norms[0], h_norms)
    dists = client.decrypt_scores_combined(
        [d_cts[0].to_wire()], d_norms, q)
    assert _max_rel(dists, base, ids, q) <= MAX_REL


def test_config3_served_gather_form_accurate(op):
    """The served form: parked base, ids, gather + f32 encode on the
    device; bit-equal to the row-upload device encode, and within the
    limit after decryption."""
    client, _, dev, base, q, ids = op
    w = client.encrypt_query_batch(q)
    r_cts, r_norms = dev.encrypted_scores_combined_batch(
        w, base[ids].astype(np.float64), "k", dev_encode=True)
    dev.set_base(base)
    g_cts, g_norms = dev.encrypted_scores_combined_batch(w, ids, "k")
    np.testing.assert_array_equal(g_cts[0].c0, r_cts[0].c0)
    np.testing.assert_array_equal(g_cts[0].c1, r_cts[0].c1)
    np.testing.assert_array_equal(g_norms, r_norms)
    dists = client.decrypt_scores_combined(
        [c.to_wire() for c in g_cts], g_norms, q)
    assert _max_rel(dists, base, ids, q) <= MAX_REL


def test_config3_per_block_bit_equal_to_jax_and_accurate(op):
    client, js, dev, base, q, ids = op
    ct = client.ctx.ct_from_wire(client.encrypt_query_batch(q)[0])
    rows = base[ids].astype(np.float64)
    h_cts, h_norms = js.encrypted_scores(
        J.CKKSCiphertext.from_wire(ct.to_wire()), rows[0], "k")
    d_res, d_norms = dev.encrypted_scores_batch([ct], rows, "k")
    assert len(d_res[0]) == len(h_cts) == P // ((N // 2) // D)
    for d, h in zip(d_res[0], h_cts):
        assert d.level == h.level == LIMBS - 1
        np.testing.assert_array_equal(d.c0, h.c0)
        np.testing.assert_array_equal(d.c1, h.c1)
    dists = client.decrypt_scores_batch(
        [[c.to_wire() for c in d_res[0]]], d_norms, q)
    assert _max_rel(dists, base, ids, q) <= MAX_REL


def test_config3_precision_on_near_candidates(op):
    """Candidates as a coarse round names them, near the query (distances
    ~2.5e4 instead of ~1.4e6): the per-block response keeps the 0.01 limit,
    while the combined one, bit-equal to the JAX package, keeps the
    reference arithmetic's absolute precision: inner products within 2^14
    (a rescale at scale 2^22 of messages of ~1, read at a final scale of
    2^5). Against distances this small that is well above 0.01."""
    client, js, dev, base, q, ids = op
    rng = np.random.default_rng(25)
    rows = np.clip(q[:, None] + np.round(rng.normal(0, 10, (1, P, D))),
                   0, 255)
    ct = client.ctx.ct_from_wire(client.encrypt_query_batch(q)[0])
    d_res, d_norms = dev.encrypted_scores_batch([ct], rows, "k")
    dists = client.decrypt_scores_batch(
        [[c.to_wire() for c in d_res[0]]], d_norms, q)
    ref = ((rows[0] - q[0]) ** 2).sum(-1)
    assert np.abs(dists[0] - ref).max() / ref.max() <= MAX_REL
    c_cts, c_norms = dev.encrypted_scores_combined_batch([ct], rows, "k")
    h_ct, _ = js.encrypted_scores_combined(
        J.CKKSCiphertext.from_wire(ct.to_wire()), rows[0], "k")
    np.testing.assert_array_equal(c_cts[0].c0, h_ct.c0)
    ips = T.extract_combined_ips(client.ctx.decrypt(client.sk, c_cts[0]),
                                 P, D)
    assert np.abs(ips - rows[0] @ q[0]).max() <= 2 ** 14
