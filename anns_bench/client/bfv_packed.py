"""The client of the BFV packed wire (``he.scheme`` "bfv", ``he.resp_mod``
"packed"), as the encrypted route loads it: ``client/<scheme>_<resp_mod>.py``.

A wire's client module holds ``Client(n, t_bits, n_limbs, seed, key_id)``
with ``galois_keys_wire(d)`` (what the first request registers, or None),
``encrypt_batch(queries)`` and ``decrypt(response, queries)`` (squared-L2
distances [nq, P] float64).
"""

from __future__ import annotations

import numpy as np

from anns_bench.client.bfv import PackedClient


class Client(PackedClient):
    def galois_keys_wire(self, d: int) -> dict:
        return self.extraction_keys_wire(d)

    def decrypt(self, response: dict, queries: np.ndarray) -> np.ndarray:
        return self.decrypt_packed(response, queries)
