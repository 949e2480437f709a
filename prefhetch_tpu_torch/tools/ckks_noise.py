"""How far the combined CKKS response's distances stray, key by key.

    python -m prefhetch_tpu_torch.tools.ckks_noise [--keys 8] [--device cuda]

At BASELINE.json config 3 (N=8192, 3 limbs, scale 2^26, d=128) the
combined response (``DeviceCKKS.encrypted_scores_combined_batch``, served
form: parked base, gather, f32 encode) is scored over each of 64 queries'
256 exact nearest rows of a 1M SIFT-style base (``make_clustered_dataset``
with the smoke's widths), once per client key (seeds 100, 101, …). For
each key it prints the decrypted distances' error: its spread, its largest
value and the median of the per-query largest. The error is absolute (the
rescale at scale 2^22 of messages of ~1, read at a final scale of 2^5) and
its size follows the key; ``chip_smoke.py`` bounds it by
``CKKS_COMBINED_MAX_ABS``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS
from prefhetch_tpu_torch.utils.config import HEParams

D, P = 128, 256


def measure(keys: int, device: str, nq: int = 64) -> list:
    """[(key seed, error std, max |error|, median per-query max |error|)]
    over ``keys`` client keys."""
    he = HEParams(scheme="ckks", n=8192, n_limbs=3, scale_bits=26,
                  resp_mod="combined")
    data = make_clustered_dataset(nbase=1_000_000, ntrain=10, nquery=nq,
                                  d=D, n_clusters=600, gt_k=1, seed=20)
    base, q = data["base"], data["query"].astype(np.float64)
    bt = torch.from_numpy(base).to(device, torch.float64)
    qt = torch.from_numpy(q).to(device)
    d2 = (qt * qt).sum(1)[:, None] + (bt * bt).sum(1)[None] - 2 * qt @ bt.T
    cand = torch.argsort(d2, 1)[:, :P].cpu().numpy()
    del bt, d2
    ref = ((base[cand].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    out = []
    for seed in range(100, 100 + keys):
        client = HEClient(he, seed=seed)
        svc = DeviceCKKS(client.params, device=device)
        svc.register_keys("k", client.galois_keys_wire(D, 8))
        svc.set_base(base)
        cts, norms = svc.encrypted_scores_combined_batch(
            client.encrypt_query_batch(q), cand.astype(np.int32), "k")
        err = client.decrypt_scores_combined(
            [c.to_wire() for c in cts], norms, q) - ref
        out.append((seed, float(err.std()), float(np.abs(err).max()),
                    float(np.median(np.abs(err).max(1)))))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for seed, std, mx, med in measure(args.keys, args.device):
        print(f"key seed {seed}: distance error std {std:.1f}, max "
              f"{mx:.1f}, per-query max median {med:.1f}", flush=True)


if __name__ == "__main__":
    main()
