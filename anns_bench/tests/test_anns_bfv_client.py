"""The frozen BFV client against the program's crypto and its packed
service: the same transforms, masks and prime chain, wires the service
accepts, and exact distances decrypted from its answers."""

import numpy as np
import torch

from anns_bench.client import bfv
from prefhetch_tpu_torch.crypto import bfv as pbfv
from prefhetch_tpu_torch.crypto.ntt import build_tables, intt_plain, ntt_plain
from prefhetch_tpu_torch.crypto.params import bfv_params_for


def _client(seed=7):
    return bfv.PackedClient(4096, 24, 2, seed=seed, key_id="k")


def test_params_tables_and_masks_match_the_program():
    c = _client()
    p = bfv_params_for(4096, 24, 2, odd_t=True)
    assert (c.params.n, c.params.t, c.params.qs) == (p.n, p.t, p.qs)
    rng = np.random.default_rng(0)
    for q in p.qs:
        mine, theirs = bfv.tables(q, 4096), build_tables(q, 4096)
        assert np.array_equal(mine.bitrev, theirs.bitrev)
        x = rng.integers(0, q, (3, 4096))
        assert np.array_equal(bfv.ntt(x, mine), ntt_plain(x, theirs))
        assert np.array_equal(bfv.intt(x, mine), intt_plain(x, theirs))
    key = np.array([123, 456789], np.uint32)
    assert np.array_equal(bfv.tf_uniform_rns(key, p.qs, 4096),
                          pbfv.tf_uniform_rns(key, p.qs, 4096))
    assert c._special_p() == pbfv.BFVContext(p)._special_p


def test_wires_decrypt_under_the_programs_context():
    c = _client()
    ctx = pbfv.BFVContext(bfv_params_for(4096, 24, 2, odd_t=True))
    q = np.random.default_rng(1).integers(0, 256, (3, 128)).astype(np.float32)
    wires = c.encrypt_batch(q)
    sk = pbfv.SecretKey(s_rns=c.s_rns)
    for w, row in zip(wires, q):
        m = ctx.decrypt(sk, ctx.ct_from_wire(w))
        assert np.array_equal(m[:128], row.astype(np.int64))
        assert not m[128:].any()


def test_packed_round_trip_through_the_programs_service():
    from prefhetch_tpu_torch.engine.hecompute import HEComputeService

    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (5000, 128)).astype(np.float32)
    q = rng.integers(0, 256, (4, 128)).astype(np.float32)
    cand = rng.choice(5000, (4, 256), replace=False).astype(np.int64)
    c = _client()
    svc = HEComputeService(bfv_params_for(4096, 24, 2, odd_t=True),
                           device=torch.device("cpu"))
    svc.set_base(base)
    svc.register_galois_keys(c.key_id, c.extraction_keys_wire(128))
    packed, norms, grp = svc.encrypted_scores_packed_wire(
        c.encrypt_batch(q), cand, c.key_id)
    resp = {"packedScores": [x.to_wire() for x in packed],
            "candidateNorms": norms.tolist(), "packGroup": grp}
    got = c.decrypt_packed(resp, q)
    want = ((base[cand].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    assert np.array_equal(got, want)
