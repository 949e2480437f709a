"""Client-side handle for the real-PIR retrieval mode (crypto/pir.py) —
the port of prefhetch_tpu/client/pir.py: one ``PIRClient`` per
(N, t, limbs, seed), so its keys (and its Galois keys, registered once with
the server) outlive a single pipeline run."""

from __future__ import annotations

from prefhetch_tpu_torch.crypto.params import pir_params_for
from prefhetch_tpu_torch.crypto.pir import PIRClient
from prefhetch_tpu_torch.utils.config import PipelineConfig

_cache = {}


def get_pir_client(config: PipelineConfig, seed=None) -> PIRClient:
    he = config.he
    key = (he.n, he.pir_plain_modulus, he.n_limbs, seed)
    if key not in _cache:
        _cache[key] = PIRClient(
            pir_params_for(he.n, he.pir_plain_modulus, he.n_limbs), seed=seed
        )
    return _cache[key]
