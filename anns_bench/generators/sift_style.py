"""``"sift_style"``: SIFT-style vectors made on the device from the
configuration's corpus seed and the run's seed.

The deployment's corpus, train set and query pool are drawn in a few large
calls with ``torch.Generator``s on the run's device: a mixture of
Gaussians in [0, value_max]^d rounded to integers, the shape of SIFT
descriptors (the same family as prefhetch_tpu_torch/data/synthetic.py's
``make_clustered_dataset``, drawn on the card instead of by numpy). The same
seeds on the same device give the same arrays. Nothing here imports the
program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def generate(spec: dict, seed: int,
             device: torch.device) -> Dict[str, np.ndarray]:
    """{"base", "train", "query"} float32 host arrays, integer-valued.

    ``spec`` is a configuration's ``dataset`` block: nbase, ntrain, nquery,
    d, n_clusters, center_range, scale_range, value_max, corpus_seed and,
    optionally, query_seed.
    The corpus (the clusters, base and train sets) is the deployment's and
    comes from ``corpus_seed``, so every run serves the same index. The
    query pool, drawn from the same clusters, comes from ``query_seed``
    where the spec states one (a fixed test set, as ann-benchmarks ships
    one; the run's seed then orders the traffic) and from ``seed`` where it
    does not."""
    g = generator(int(spec["corpus_seed"]), device)
    d, nc = int(spec["d"]), int(spec["n_clusters"])
    clo, chi = spec["center_range"]
    slo, shi = spec["scale_range"]
    vmax = float(spec["value_max"])
    centers = torch.rand((nc, d), generator=g, device=device) * (chi - clo) + clo
    scales = torch.rand((nc, 1), generator=g, device=device) * (shi - slo) + slo

    def sample(n: int, gen: torch.Generator) -> np.ndarray:
        which = torch.randint(0, nc, (n,), generator=gen, device=device)
        x = torch.randn((n, d), generator=gen, device=device)
        x.mul_(scales[which]).add_(centers[which])
        return x.round_().clamp_(0.0, vmax).cpu().numpy()

    base = sample(int(spec["nbase"]), g)
    train = sample(int(spec["ntrain"]), g)
    qseed = spec.get("query_seed")
    query = sample(int(spec["nquery"]),
                   generator(seed if qseed is None else int(qseed), device))
    return {"base": base, "train": train, "query": query}
