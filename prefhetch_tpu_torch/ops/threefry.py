"""The threefry-seeded RLWE mask on the device: ``tf_uniform_rns`` for a
batch of keys, in plain PyTorch.

The port of the jnp form of prefhetch_tpu/crypto/bfv.py ``tf_uniform_rns``
(:200-216), which the JAX package runs with jnp ops inside its jitted packed
program, outside any Pallas kernel. The host (numpy) form is
crypto/bfv.py ``tf_uniform_rns``; the two are bit-equal, and through it the
JAX package's numpy and jnp forms (tests/test_torch_threefry.py).

Counter layout (the frozen wire contract): 2·L·N lanes of Threefry-2x32-20
with counters iota(2·L·N) split in half; draw i of limb l takes the top 30
bits of out0[l·N + i] above the 32 bits of out1[l·N + i], a 62-bit value v,
and its residue mod q_l.

The uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` after every add
and left shift: PyTorch's CUDA coverage of ``torch.uint32`` is partial, and
a right shift of int32 is arithmetic. Every value stays below 2^62, so
int64 holds it exactly, and ``v % q`` is the canonical residue the host
form's shift reduction gives.
"""

from __future__ import annotations

from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32_20(k0, k1, x0, x1):
    """Threefry-2x32-20 on int64 tensors holding u32 values (broadcast
    keys [nq, 1] against counters [1, n])."""
    def rotl(v, r):
        return ((v << r) & _M32) | (v >> (32 - r))

    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _TF_ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def tf_uniform_rns(keys: torch.Tensor, qs: Sequence[int],
                   n: int) -> torch.Tensor:
    """keys [nq, 2] (uint32 values in any integer dtype; the wire's
    "seedTf") → [nq, L, N] int64 uniform residues, on keys' device."""
    L = len(qs)
    total = L * n
    k = keys.to(torch.int64) & _M32
    cnt = torch.arange(2 * total, dtype=torch.int64, device=keys.device)
    o0, o1 = _threefry2x32_20(k[:, :1], k[:, 1:], cnt[None, :total],
                              cnt[None, total:])
    v = ((o0 >> 2) << 32) | o1                      # uniform < 2^62
    q = torch.tensor(list(qs), dtype=torch.int64, device=keys.device)
    return v.reshape(-1, L, n) % q[None, :, None]
