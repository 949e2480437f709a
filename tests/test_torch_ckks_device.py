"""Port parity: ``DeviceCKKS`` (engine/ckks_device.py) on CPU tensors, where
kernel K2's wrapper takes its plain version, against the JAX package's
numpy ``CKKSComputeService``, at the fixtures of tests/test_ckks_device.py
(N=256, D=32, 3 limbs, scale 2^20 and 2^26). The JAX tests hold their
``DeviceCKKS`` bit-equal to that service, so this holds the port to both.

All integer: c0 and c1 bit-equal, levels equal, scales to 1e-6 relative.
Within the port: the seedTf entry equals its expanded wire, the parked-base
gather equals the row-upload device encode, the device encode equals the
host encode where the JAX test asserts it (small coefficients), and the
refusals. The port's numpy twin (engine/hecompute.py
``CKKSComputeService``) is held to the JAX one too."""

import numpy as np
import pytest
import torch

from prefhetch_tpu.crypto import ckks as J
from prefhetch_tpu.crypto.params import CKKSParams as JParams
from prefhetch_tpu.engine.hecompute import CKKSComputeService as JService
from prefhetch_tpu_torch.crypto import ckks as T
from prefhetch_tpu_torch.crypto.params import CKKSParams as TParams
from prefhetch_tpu_torch.crypto.params import find_ntt_primes
from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS
from prefhetch_tpu_torch.engine.hecompute import CKKSComputeService as TService
from prefhetch_tpu_torch.ops import ntt4_fused, ntt4_step

torch.set_num_threads(1)

N, D, LIMBS = 256, 32, 3
STEPS = T.rotation_steps(D)


def _fixture(scale_bits, digit_bits=15, combine_blocks=4, seed=7):
    """(JAX params, port params, port context, sk, pk, Galois key wire) with
    keys for the IP tree and, for combine_blocks > 1, the combine tree."""
    qs = tuple(find_ntt_primes(N, 30, LIMBS))
    tp = TParams(n=N, scale_bits=scale_bits, qs=qs)
    ctx = T.CKKSContext(tp)
    rng = np.random.default_rng(seed)
    sk, pk = ctx.keygen(rng)
    steps = STEPS + ctx.combine_tree_steps(combine_blocks, D)
    gks = ctx.galois_keygen(sk, steps, rng, digit_bits=digit_bits)
    wire = {str(s): k.to_wire() for s, k in gks.items()}
    return JParams(n=N, scale_bits=scale_bits, qs=qs), tp, ctx, sk, pk, wire


@pytest.fixture(scope="module")
def s20():
    return _fixture(20)


@pytest.fixture(scope="module")
def s26():
    return _fixture(26)


def _query_ct(ctx, pk, seed):
    q = np.random.default_rng(seed).integers(0, 30, size=D).astype(np.float64)
    ct = ctx.encrypt(pk, ctx.encode(np.tile(q, (N // 2) // D)),
                     np.random.default_rng(seed + 100))
    return q, ct


def _cands(seed, p=10):
    return np.random.default_rng(seed).integers(0, 30, size=(p, D)).astype(
        np.float64)


def _same(a, b):
    assert a.level == b.level
    assert abs(a.scale - b.scale) <= 1e-6 * abs(b.scale)
    np.testing.assert_array_equal(a.c0, b.c0)
    np.testing.assert_array_equal(a.c1, b.c1)


def _jct(ct):
    return J.CKKSCiphertext.from_wire(ct.to_wire())


def _services(fx, key_id="k"):
    jp, tp, *_, wire = fx
    js, ts, dev = JService(jp), TService(tp), DeviceCKKS(tp, device="cpu")
    for s in (js, ts, dev):
        s.register_keys(key_id, wire)
    return js, ts, dev


@pytest.mark.parametrize("fx,p", [("s20", 10), ("s20", 4), ("s26", 10)])
def test_per_block_bit_equal_to_jax_service(request, fx, p):
    """encrypted_scores (one query): every block ct equal to the JAX
    numpy service's and to the port's numpy twin; norms equal; one K2 per
    transform and no plain-version launch outside the wrapper."""
    fx = request.getfixturevalue(fx)
    ctx, pk = fx[2], fx[4]
    js, ts, dev = _services(fx)
    q, ct = _query_ct(ctx, pk, 1)
    cands = _cands(2, p)
    h_cts, h_norms = js.encrypted_scores(_jct(ct), cands, "k")
    t_cts, t_norms = ts.encrypted_scores(ct, cands, "k")
    d_cts, d_norms = dev.encrypted_scores(ct, cands, "k")
    assert len(d_cts) == len(h_cts) == -(-p // ((N // 2) // D))
    for h, t, d in zip(h_cts, t_cts, d_cts):
        _same(t, h)
        _same(d, h)
    np.testing.assert_array_equal(d_norms, h_norms)
    np.testing.assert_array_equal(t_norms, h_norms)
    # the rotate-left sum lands at slot j·d
    vals = np.concatenate([np.real(ctx.decrypt(fx[3], c))[::D]
                           for c in d_cts])[:p]
    np.testing.assert_allclose(vals, cands @ q, rtol=2e-3, atol=0.5)


def test_per_block_batch_equals_single_queries(s20):
    """encrypted_scores_batch (nq=3, one program) equals three single
    calls and the JAX service limb for limb; the resolver is lazy."""
    ctx, pk = s20[2], s20[4]
    js, _, dev = _services(s20)
    cts = [_query_ct(ctx, pk, 10 + i)[1] for i in range(3)]
    cands = np.stack([_cands(20 + i, 6) for i in range(3)])
    resolve = dev.encrypted_scores_batch_async(cts, cands, "k")
    assert resolve.dev_out.shape == (3 * 2, 2, LIMBS - 1, N)
    res, norms = resolve()
    for i in range(3):
        h_cts, h_norms = js.encrypted_scores(_jct(cts[i]), cands[i], "k")
        np.testing.assert_array_equal(norms[i], h_norms)
        for b, h in zip(res[i], h_cts):
            _same(b, h)


@pytest.mark.parametrize("fx", ["s20", "s26"])
def test_combined_host_encode_bit_equal_to_jax_service(request, fx):
    """encrypted_scores_combined_batch with host encode (the default) on a
    full ciphertext and on its seedTf wire: the one level-1 ct equals the
    JAX numpy service's and the port's numpy twin's; 2^26 decodes to the
    inner products at the combined layout (j·d + W·b)."""
    fx = request.getfixturevalue(fx)
    ctx, sk, pk = fx[2], fx[3], fx[4]
    js, ts, dev = _services(fx)
    q = np.random.default_rng(5).integers(0, 30, size=D).astype(np.float64)
    cands = _cands(6)
    w = ctx.encrypt_symmetric_tf(sk, ctx.encode(np.tile(q, (N // 2) // D)),
                                 np.random.default_rng(8))
    ct = ctx.ct_from_wire(w)
    h_ct, h_norms = js.encrypted_scores_combined(_jct(ct), cands, "k")
    t_ct, t_norms = ts.encrypted_scores_combined(ct, cands, "k")
    _same(t_ct, h_ct)
    np.testing.assert_array_equal(t_norms, h_norms)
    for entry in (ct, w):                    # expanded and seedTf wire
        d_cts, d_norms = dev.encrypted_scores_combined_batch(
            [entry], cands[None], "k")
        assert d_cts[0].level == 1
        _same(d_cts[0], h_ct)
        np.testing.assert_array_equal(d_norms[0], h_norms)
    if fx[1].scale_bits == 26:
        ips = T.extract_combined_ips(ctx.decrypt(sk, d_cts[0]), 10, D)
        ref = cands @ q
        assert np.abs(ips - ref).max() <= max(2e-2 * np.abs(ref).max(), 1.0)


def test_combined_batch_equals_jax_per_query(s26):
    """encrypted_scores_combined_batch over nq=3 queries (one program,
    host encode) equals the JAX service query by query."""
    ctx, pk = s26[2], s26[4]
    js, _, dev = _services(s26)
    cts = [_query_ct(ctx, pk, 50 + i)[1] for i in range(3)]
    cands = np.stack([_cands(60 + i, 7) for i in range(3)])
    d_cts, d_norms = dev.encrypted_scores_combined_batch(cts, cands, "k")
    for i in range(3):
        h_ct, h_norms = js.encrypted_scores_combined(_jct(cts[i]), cands[i],
                                                     "k")
        _same(d_cts[i], h_ct)
        np.testing.assert_array_equal(d_norms[i], h_norms)


@pytest.mark.parametrize("nq", [1, 3])
def test_combined_gather_equals_row_upload_device_encode(s26, nq):
    """Parked-base mode (set_base + [nq, P] int ids): the gather, the norms
    and the f32 encode in the device program equal the row-upload device
    encode bit for bit (same f32 slot rows, same product), for seedTf
    wires; norms equal the host norms."""
    ctx, sk = s26[2], s26[3]
    _, _, dev = _services(s26)
    base = np.random.default_rng(30).integers(0, 30, (50, D)).astype(
        np.float32)
    ids = np.stack([np.random.default_rng(31 + i).permutation(50)[:10]
                    for i in range(nq)]).astype(np.int32)
    wires = [ctx.encrypt_symmetric_tf(
        sk, ctx.encode(np.tile(base[i], (N // 2) // D)),
        np.random.default_rng(40 + i)) for i in range(nq)]
    rows = base[ids].astype(np.float64)
    r_cts, r_norms = dev.encrypted_scores_combined_batch(
        wires, rows, "k", dev_encode=True)
    with pytest.raises(ValueError, match="set_base"):
        dev.encrypted_scores_combined_batch(wires, ids, "k")
    dev.set_base(base)
    assert dev._base_dev.shape == (51, D)
    assert not dev._base_dev[-1].any()                 # the zero pad row
    g_cts, g_norms = dev.encrypted_scores_combined_batch(wires, ids, "k")
    for g, r in zip(g_cts, r_cts):
        _same(g, r)
    np.testing.assert_array_equal(g_norms, r_norms)
    np.testing.assert_array_equal(
        g_norms, (base[ids].astype(np.int64) ** 2).sum(-1))


def test_combined_device_encode_equals_host_encode_at_small_scale(s20):
    """At scale 2^20 (the JAX test's fixture, small coefficients) the f32
    device encode rounds to the host FFT's integers: the result cts are
    equal."""
    ctx, pk = s20[2], s20[4]
    _, _, dev = _services(s20)
    _, ct = _query_ct(ctx, pk, 21)
    cands = _cands(22)
    h_cts, h_norms = dev.encrypted_scores_combined_batch([ct], cands[None],
                                                         "k")
    d_cts, d_norms = dev.encrypted_scores_combined_batch(
        [ct], cands[None], "k", dev_encode=True)
    _same(d_cts[0], h_cts[0])
    np.testing.assert_array_equal(d_norms, h_norms)


def test_digit_bits_taken_from_the_key_wire(s20):
    """Keys made at 30-bit digits are switched at 30 bits (the width
    travels in the wire): per-block and combined equal the JAX service."""
    fx = _fixture(20, digit_bits=30, seed=11)
    ctx, pk = fx[2], fx[4]
    js, _, dev = _services(fx, "k30")
    assert dev._key_digits["k30"] == 30
    _, ct = _query_ct(ctx, pk, 12)
    cands = _cands(13, 6)
    h_cts, _ = js.encrypted_scores(_jct(ct), cands, "k30")
    d_cts, _ = dev.encrypted_scores(ct, cands, "k30")
    for h, d in zip(h_cts, d_cts):
        _same(d, h)
    h_ct, _ = js.encrypted_scores_combined(_jct(ct), cands, "k30")
    d_cmb, _ = dev.encrypted_scores_combined_batch([ct], cands[None], "k30")
    _same(d_cmb[0], h_ct)


def test_k2_launch_count_and_plain_version_on_cpu(s20):
    """On CPU tensors every transform takes K2's plain version (no launch):
    a per-block request of P=10 (3 blocks) runs 2·3 ct×pt transforms and
    log2(D)·2·3 key-switch transforms, each one plain transform."""
    ctx, pk = s20[2], s20[4]
    _, _, dev = _services(s20)
    _, ct = _query_ct(ctx, pk, 3)
    ntt4_fused.ntt4_transform.launches = 0
    ntt4_step.ntt4_step_plain.calls = 0
    dev.encrypted_scores(ct, _cands(4), "k")
    assert ntt4_fused.ntt4_transform.launches == 0
    # two plain stages a transform
    assert ntt4_step.ntt4_step_plain.calls == 2 * (2 * LIMBS
                                                   + len(STEPS) * 2 * LIMBS)


def test_refusals(s20, s26):
    """A missing key, an unknown keyId, a digitBits that disagrees with the
    key's shape, a query below level 3 for the combined response, a query
    ciphertext of the wrong shape, a malformed seedTf, and the device
    rule."""
    ctx, pk = s20[2], s20[4]
    tp, wire = s20[1], s20[5]
    dev = DeviceCKKS(tp, device="cpu")
    dev.register_keys("k", {k: v for k, v in wire.items() if int(k) != 1})
    _, ct = _query_ct(ctx, pk, 1)
    with pytest.raises(ValueError, match="missing Galois key for step 1"):
        dev.encrypted_scores(ct, np.ones((3, D)), "k")
    with pytest.raises(ValueError, match="unknown CKKS keyId"):
        dev.encrypted_scores(ct, np.ones((3, D)), "nope")
    bad = {k: dict(v, digitBits=30) for k, v in wire.items()}
    with pytest.raises(ValueError, match="digitBits"):
        dev.register_keys("bad", bad)
    jdev = JService(s20[0])                 # the JAX service's text too
    jdev.register_keys("k", s26[5])
    low = T.CKKSCiphertext(c0=ct.c0[:2], c1=ct.c1[:2], level=2,
                           scale=ct.scale)
    dev.register_keys("k", wire)
    for svc, c in ((dev, low), (jdev, _jct(low))):
        with pytest.raises(ValueError, match="needs a level-3 query ct"):
            if svc is dev:
                svc.encrypted_scores_combined_batch([c], _cands(1)[None], "k")
            else:
                svc.encrypted_scores_combined(c, _cands(1), "k")
    with pytest.raises(ValueError, match="must be"):
        dev.encrypted_scores(
            T.CKKSCiphertext(c0=ct.c0[:, :8], c1=ct.c1[:, :8], level=3,
                             scale=ct.scale), np.ones((3, D)), "k")
    with pytest.raises(ValueError, match="seedTf"):
        w = ctx.encrypt_symmetric_tf(s20[3], ctx.encode(np.ones(N // 2)),
                                     np.random.default_rng(0))
        dev.encrypted_scores_combined_batch([dict(w, seedTf=[1, -1])],
                                            _cands(1)[None], "k")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceCKKS(tp)


def test_reregistering_a_key_drops_its_schedules(s20):
    """Registering a keyId again (key rotation) replaces the cached
    per-key schedules: the next request switches with the new keys."""
    ctx, pk = s20[2], s20[4]
    fx2 = _fixture(20, seed=99)
    js2 = JService(fx2[0])
    js2.register_keys("k", fx2[5])
    _, _, dev = _services(s20)
    _, ct = _query_ct(ctx, pk, 5)
    cands = _cands(6)
    dev.encrypted_scores(ct, cands, "k")
    assert any(k[0] == "k" for k in dev._sched_cache)
    dev.register_keys("k", fx2[5])
    assert not any(k[0] == "k" for k in dev._sched_cache)
    d_cts, _ = dev.encrypted_scores(ct, cands, "k")
    for d, h in zip(d_cts, js2.encrypted_scores(_jct(ct), cands, "k")[0]):
        _same(d, h)
