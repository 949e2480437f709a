"""Port parity: BFV whole-ciphertext per-block scores —
``HEComputeService.encrypted_scores(_batch)`` (engine/hecompute.py) and the
BFV ``HEClient.decrypt_scores(_batch)`` (client/he.py) — against the JAX
package, and the slice as a whole.

All integer: tolerance zero. The JAX service runs its numpy backend and its
jitted device program (``backend="tpu"``) on CPU JAX, as
tests/test_hecompute_backends.py runs them (the numpy backend on its
butterfly: the JAX loader's native switch is turned off here, so no test
builds into native/build/). The port runs its torch program on CPU tensors,
where kernel K2's wrapper takes its plain version; its numpy twin
``_mac_numpy`` is the independent oracle."""

import numpy as np
import pytest
import torch

from prefhetch_tpu.client.he import HEClient as JClient
from prefhetch_tpu.crypto import ntt as j_ntt
from prefhetch_tpu.crypto.bfv import BFVContext as JContext
from prefhetch_tpu.crypto.packing import encode_query_poly
from prefhetch_tpu.crypto.params import BFVParams, find_ntt_primes
from prefhetch_tpu.engine.hecompute import HEComputeService as JService
from prefhetch_tpu.utils.config import HEParams as JHEParams
from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.crypto.bfv import Ciphertext
from prefhetch_tpu_torch.crypto.packing import pack_candidates
from prefhetch_tpu_torch.crypto.params import bfv_params_for
from prefhetch_tpu_torch.engine.hecompute import HEComputeService as TService
from prefhetch_tpu_torch.ops import ntt4
from prefhetch_tpu_torch.utils.config import HEParams

torch.set_num_threads(1)

D, N = 32, 256


@pytest.fixture(autouse=True)
def _jax_butterfly(monkeypatch):
    monkeypatch.setattr(j_ntt, "_NATIVE_DISABLED", True)


@pytest.fixture(scope="module")
def setup():
    """tests/test_hecompute_backends.py's fixture: N=256, t=2^24, 2 limbs,
    3 queries x 20 candidates of d=32 (P not a multiple of B=8)."""
    rng = np.random.default_rng(11)
    p = BFVParams(n=N, t=1 << 24, qs=tuple(find_ntt_primes(N, 30, 2)))
    ctx = JContext(p)
    sk, pk = ctx.keygen(rng)
    q = rng.integers(0, 256, D).astype(np.float32)
    X = rng.integers(0, 256, (3, 20, D)).astype(np.float32)
    X[1, 3] = -X[1, 3]                    # signed data: the negative lift
    cts = [ctx.to_ntt(ctx.encrypt(pk, encode_query_poly(q, p), rng))
           for _ in range(3)]
    return p, q, X, cts


def _port_cts(cts):
    return [Ciphertext(c0=c.c0, c1=c.c1, is_ntt=c.is_ntt) for c in cts]


def _counting_k2(monkeypatch):
    """Counts the transforms ops/ntt4 hands to K2's wrapper (on CPU
    tensors the wrapper runs its plain version and counts no launch)."""
    seen = []
    real = ntt4.ntt4_transform

    def count(x, tb, inverse):
        seen.append((tuple(x.shape), bool(inverse)))
        return real(x, tb, inverse)

    monkeypatch.setattr(ntt4, "ntt4_transform", count)
    return seen


def test_batch_matches_jax_numpy_and_device_program(setup, monkeypatch):
    """tests/test_hecompute_backends.py::test_batch_backends_agree for the
    port: the port's CPU program bit-equal (values) to the JAX numpy
    backend, the JAX jitted device program and the port's numpy twin; one
    forward transform a limb over all (query, block) rows."""
    p, q, X, cts = setup
    ts = TService(p, device="cpu")
    seen = _counting_k2(monkeypatch)
    r_t, n_t = ts.encrypted_scores_batch(_port_cts(cts), X)
    assert seen == [((3 * 3, N), False)] * len(p.qs)
    r_np, n_np = JService(p, backend="numpy").encrypted_scores_batch(cts, X)
    r_dev, n_dev = JService(p, backend="tpu").encrypted_scores_batch(cts, X)
    np.testing.assert_array_equal(n_t, n_np)
    np.testing.assert_array_equal(n_t, n_dev)
    assert len(r_t) == 3 and all(len(b) == 3 for b in r_t)
    for qi in range(3):
        polys, _ = pack_candidates(X[qi], p)
        o0, o1 = ts._mac_numpy(cts[qi].c0, cts[qi].c1, polys)
        for b, ct in enumerate(r_t[qi]):
            assert ct.is_ntt and ct.c0.shape == (len(p.qs), N)
            for ref in (r_np[qi][b], r_dev[qi][b]):
                np.testing.assert_array_equal(ct.c0, ref.c0)
                np.testing.assert_array_equal(ct.c1, ref.c1)
            np.testing.assert_array_equal(ct.c0, o0[b])
            np.testing.assert_array_equal(ct.c1, o1[b])


def test_single_matches_jax_and_the_batch(setup):
    """test_single_backends_agree for the port: one query's
    ``encrypted_scores`` equals the JAX backends' and that query's row of
    the batch; a coefficient-domain query ct is moved to NTT on the host."""
    p, q, X, cts = setup
    ts = TService(p, device="cpu")
    got, norms = ts.encrypted_scores(_port_cts(cts)[0], X[0])
    batch, _ = ts.encrypted_scores_batch(_port_cts(cts), X)
    for backend in ("numpy", "tpu"):
        want, jn = JService(p, backend=backend).encrypted_scores(cts[0], X[0])
        np.testing.assert_array_equal(norms, jn)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.c0, b.c0)
            np.testing.assert_array_equal(a.c1, b.c1)
    for a, b in zip(got, batch[0]):
        np.testing.assert_array_equal(a.c0, b.c0)
        np.testing.assert_array_equal(a.c1, b.c1)
    ctx = ts.ctx
    coeff = Ciphertext(c0=ctx.ntt_inv(cts[0].c0), c1=ctx.ntt_inv(cts[0].c1))
    again, _ = ts.encrypted_scores(coeff, X[0])
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.c0, b.c0)
        np.testing.assert_array_equal(a.c1, b.c1)


def test_candidates_refused_as_jax_refuses(setup):
    p, q, X, cts = setup
    ts = TService(p, device="cpu")
    js = JService(p, backend="numpy")
    for bad, text in ((X + 0.5, "integer-valued"),
                      (X + (1 << 23), "exceeds the plaintext half-window")):
        for svc, c in ((ts, _port_cts(cts)), (js, cts)):
            with pytest.raises(ValueError, match=text):
                svc.encrypted_scores_batch(c, bad)


@pytest.mark.parametrize("signed", [False, True])
def test_slice_exact_distances_and_jax_decryption(signed):
    """The slice as a whole: the port's client encrypts, the service
    computes whole result ciphertexts on CPU tensors, they cross the wire
    (to_wire) and ``decrypt_scores_batch`` gives the exact float64
    distances, max |err| 0, on signed data too; equal to the JAX client's
    decryption of the JAX service's output for the same seed."""
    rng = np.random.default_rng(21)
    queries = rng.integers(0, 256, (4, D)).astype(np.float32)
    cand = rng.integers(0, 256, (4, 20, D)).astype(np.float32)
    if signed:                    # a negated candidate row, as
        cand[2, 5] = -cand[2, 5]  # tests/test_torch_hecompute.py's base
    client = HEClient(HEParams(n=N, t_bits=24, n_limbs=2), seed=7)
    ts = TService(bfv_params_for(N, 24, 2), device="cpu")
    cts = [ts.ctx.ct_from_wire(w) for w in client.encrypt_query_batch(queries)]
    blocks, norms = ts.encrypted_scores_batch(cts, cand)
    wires = [[ct.to_wire() for ct in per_q] for per_q in blocks]
    got = client.decrypt_scores_batch(wires, norms, queries)
    exact = ((queries[:, None].astype(np.float64) - cand) ** 2).sum(-1)
    assert got.dtype == np.float32 and got.shape == (4, 20)
    assert float(np.abs(got - exact).max()) == 0.0
    for i in range(4):
        np.testing.assert_array_equal(
            client.decrypt_scores(wires[i], norms[i], queries[i]), got[i])

    jclient = JClient(JHEParams(n=N, t_bits=24, n_limbs=2), seed=7)
    js = JService(bfv_params_for(N, 24, 2), backend="numpy")
    jcts = [js.ctx.ct_from_wire(w)
            for w in jclient.encrypt_query_batch(queries)]
    jblocks, jnorms = js.encrypted_scores_batch(jcts, cand)
    jwires = [[ct.to_wire() for ct in per_q] for per_q in jblocks]
    assert jwires == wires
    np.testing.assert_array_equal(
        jclient.decrypt_scores_batch(jwires, jnorms, queries), got)
