"""Cryptographically secure randomness for key material and noise.

Copy of prefhetch_tpu/crypto/rng.py (numpy only): the same integer seed gives
the same stream in both packages.

The reference reserved the crypto layer entirely (SEAL linked, never called
— reference: CMakeLists.txt:33-38); this module supplies the RNG contract
that layer needs: secrets, ternary noise, and encryption errors must come
from OS entropy through a CSPRNG, never from a seeded statistical PRNG.

``SecureRNG`` exposes the ``numpy.random.Generator.integers`` subset the
crypto modules use, backed by a SHAKE-256 XOF keyed with 48 bytes from
``secrets.token_bytes`` (an extendable-output function of a secret key is a
standard CSPRNG construction). Sampling is exact-uniform: power-of-two
ranges are bit masks; other ranges use vectorized rejection sampling.

``secure_rng(seed)`` is the factory every key-holding object should use:
``seed=None`` (the only production mode) yields a ``SecureRNG``; an integer
seed yields a deterministic ``numpy`` generator and is for tests only.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Optional, Union

import numpy as np


class SecureRNG:
    """CSPRNG with the ``.integers`` interface the crypto layer uses."""

    _CHUNK = 1 << 16

    def __init__(self, key: Optional[bytes] = None):
        self._key = secrets.token_bytes(48) if key is None else key
        self._counter = 0
        self._buf = memoryview(b"")

    def _bytes(self, n: int) -> np.ndarray:
        """n bytes of keystream as a uint8 array."""
        out = np.empty(n, np.uint8)
        filled = 0
        while filled < n:
            if not len(self._buf):
                h = hashlib.shake_256(
                    self._key + self._counter.to_bytes(8, "little")
                )
                self._counter += 1
                self._buf = memoryview(h.digest(self._CHUNK))
            take = min(n - filled, len(self._buf))
            out[filled : filled + take] = np.frombuffer(
                self._buf[:take], np.uint8
            )
            self._buf = self._buf[take:]
            filled += take
        return out

    def _uniform_below(self, bound: int, count: int) -> np.ndarray:
        """count exact-uniform uint64 draws in [0, bound), bound ≤ 2^63."""
        if bound == 1:          # degenerate range: the only value is 0
            return np.zeros(count, np.uint64)
        nbits = max(1, (bound - 1).bit_length())
        nbytes = (nbits + 7) // 8
        mask = np.uint64((1 << nbits) - 1)
        pow2 = bound == (1 << nbits)
        out = np.empty(count, np.uint64)
        filled = 0
        while filled < count:
            need = count - filled
            # oversample for the rejection loop (mask keeps ≥ bound/2^nbits
            # ≥ 1/2 of draws, so 2× + slack nearly always finishes in one go)
            n_draw = need if pow2 else (2 * need + 16)
            raw = self._bytes(n_draw * nbytes)
            vals = np.zeros(n_draw, np.uint64)
            for b in range(nbytes):
                vals |= raw[b::nbytes].astype(np.uint64) << np.uint64(8 * b)
            vals &= mask
            if not pow2:
                vals = vals[vals < bound]
            take = min(need, vals.shape[0])
            out[filled : filled + take] = vals[:take]
            filled += take
        return out

    def binomial_half(self, k: int, size) -> np.ndarray:
        """Binomial(k, 1/2) draws via popcount of k keystream bits each —
        the vectorized sampler for centered-binomial HE noise."""
        count = int(np.prod(size))
        nbytes = (k + 7) // 8
        raw = self._bytes(count * nbytes).reshape(count, nbytes)
        bits = np.unpackbits(raw, axis=1, count=k)
        return bits.sum(axis=1).astype(np.int64).reshape(size)

    def integers(self, low, high=None, size=None, dtype=np.int64):
        """Uniform integers in [low, high) — numpy Generator semantics
        (``endpoint`` unsupported; high required implicitly via the crypto
        call sites but numpy's one-arg form is honored too)."""
        if high is None:
            low, high = 0, low
        low, high = int(low), int(high)
        assert high > low
        span = high - low
        scalar = size is None
        count = 1 if scalar else int(np.prod(size))
        vals = self._uniform_below(span, count).astype(np.int64) + low
        vals = vals.astype(dtype)
        if scalar:
            return vals[0]
        return vals.reshape(size)


def secure_rng(
    seed: Optional[Union[int, np.random.Generator, SecureRNG]] = None,
):
    """RNG factory for key-holding objects.

    ``None`` (production) → OS-entropy ``SecureRNG``. An integer seed →
    deterministic numpy generator, allowed in TESTS ONLY — deterministic
    keys make every ciphertext publicly decryptable. Passing an existing
    generator returns it unchanged (shared-stream composition)."""
    if seed is None:
        return SecureRNG()
    if isinstance(seed, (np.random.Generator, SecureRNG)):
        return seed
    return np.random.default_rng(seed)
