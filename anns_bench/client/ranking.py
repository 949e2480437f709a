"""The client's centroid ranking (protocol stage 3).

The rule of prefhetch_tpu_torch/client/pipeline.py
``sort_nearest_centroids``: every centroid by squared L2 in float64,
ascending, ties toward the lower centroid id; the request names the nprobe
prefix. Computed here as ‖q‖² − 2·q·c + ‖c‖² in blocks, so that a 10K-query
pool ranks in a fraction of a second.
"""

from __future__ import annotations

import numpy as np


def nearest_centroids(queries: np.ndarray, centroids: np.ndarray,
                      nprobe: int, block: int = 2048) -> np.ndarray:
    """[nq, nprobe] int64 centroid ids, nearest first."""
    c = centroids.astype(np.float64)
    csq = (c * c).sum(1)
    out = np.empty((len(queries), nprobe), np.int64)
    for s in range(0, len(queries), block):
        q = queries[s: s + block].astype(np.float64)
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ c.T) + csq[None]
        out[s: s + block] = np.argsort(d2, axis=1, kind="stable")[:, :nprobe]
    return out
