"""Four-step negacyclic NTT on the device — the port of the four-step half of
prefhetch_tpu/ops/ntt_mxu.py (``build_ntt4_tables``, ``ntt4``, ``intt4``,
``modmul``) and of ops/ntt_pallas.py's two-stage composition.

With N = N1·N2, ω of order N, ω1 = ω^{N2}, ω2 = ω^{N1} and A the input as
[N1, N2]:

    X[j2·N1 + j1] = Σ_{k2} ω2^{j2k2} · ω^{j1k2} · Σ_{k1} A[k1,k2] ω1^{j1k1}

is two small modular matrix products (N1² and N2²) and one twiddle multiply.
On the card the whole transform is one launch of kernel K2
(ops/ntt4_fused.py); its plain version, which a CPU tensor runs, is two
stages of ``ntt4_step_plain`` (ops/ntt4_step.py) with the transposes
between them (``transform_plain``). The negacyclic ψ-twists are folded
into the static tables (ψ^k = ψ^{k1·N2}·ψ^{k2} scales W1's contraction
columns and rides the middle twiddle), exactly as the JAX package folds them.

The forward output lands in four-step order (position j1·N2 + j2 holds
natural index j2·N1 + j1), canonical [0, q); ``intt4`` consumes that order
and returns natural order. All NTT-domain consumers are pointwise, so the
order is a private convention; ``fourstep_perm`` converts.

What the port leaves behind: the dense N×N transform
(``ntt_mxu``/``intt_mxu``, not on a served path yet), and
``shift_mod_reduce``: the card has native 64-bit integer arithmetic, so
``modmul`` is ``%`` on the int64 product, which is exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from prefhetch_tpu_torch.crypto.params import root_of_unity
from prefhetch_tpu_torch.ops.ntt4_fused import ntt4_transform
from prefhetch_tpu_torch.ops.ntt4_step import NTT4Step, ntt4_step_plain


class NTT4Tables(NamedTuple):
    q: int
    n: int
    n1: int
    n2: int
    # the four stages. Their tables are the residue matrices M[j, k] that
    # prefhetch_tpu/ops/ntt_mxu.py:253-271 has before its digit
    # decomposition, transposed into right-multiply form W[k, j]
    f_a: NTT4Step            # forward: contract k1 with ω1^{j1·k1}·ψ^{k1·N2},
                             # twiddle ω^{j1·k2}·ψ^{k2}
    f_b: NTT4Step            # forward: contract k2 with ω2^{j2·k2}, canonical
    g_a: NTT4Step            # inverse: contract j2 with ω2^{-j2·k2}, twiddle
                             # ω^{-j1·k2}·ψ^{-k2}
    g_b: NTT4Step            # inverse: contract j1 with
                             # ω1^{-j1·k1}·ψ^{-k1·N2}·N⁻¹, canonical out


@functools.lru_cache(maxsize=None)
def build_ntt4_tables(q: int, n: int, n1: int | None = None) -> NTT4Tables:
    if n1 is None:
        n1 = 1 << ((n.bit_length() - 1) // 2)      # ~√N, power of two
    assert n % n1 == 0
    n2 = n // n1
    psi = root_of_unity(q, 2 * n)
    inv_psi = pow(psi, -1, q)
    w = pow(psi, 2, q)                             # ω of order N
    inv_w = pow(w, -1, q)
    inv_n = pow(n, -1, q)

    def powvec(base, count):
        out = np.empty(count, np.int64)
        v = 1
        for i in range(count):
            out[i] = v
            v = v * base % q
        return out

    def mat(base, m):
        row = powvec(base, m)
        jj, kk = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        return row[(jj * kk) % m]

    w1 = pow(w, n2, q)
    w2 = pow(w, n1, q)
    W1 = mat(w1, n1)                               # ω1^{j1·k1}, symmetric
    W2 = mat(w2, n2)
    W1i = mat(pow(w1, -1, q), n1)
    W2i = mat(pow(w2, -1, q), n2)
    # forward: the input index k1 is the contraction axis → scale W1's
    # columns by ψ^{k1·N2}. Inverse: the output index k1 is axis 0 → scale
    # W1i's rows by ψ^{-k1·N2}·N⁻¹.
    psiN2 = powvec(pow(psi, n2, q), n1)            # ψ^{k1·N2}
    ipsiN2 = powvec(pow(inv_psi, n2, q), n1)
    W1f = W1 * psiN2[None, :] % q
    W1g = W1i * (ipsiN2 * inv_n % q)[:, None] % q
    j1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    wp = powvec(w, n)
    iwp = powvec(inv_w, n)
    psiv = powvec(psi, n2)                          # ψ^{k2}
    ipsiv = powvec(inv_psi, n2)
    f_tw = wp[(j1 * k2) % n] * psiv[None, :] % q
    g_tw = iwp[(j1 * k2) % n] * ipsiv[None, :] % q
    assert (1 << 30) - q < (1 << 20)
    # a stage multiplies on the right, out[.., j] = Σ_k in[.., k]·W[k, j], so
    # each stage takes the transpose of M[j, k]; stage a's twiddle is indexed
    # [row, output column] of that stage's [B, r, m] block
    return NTT4Tables(
        q=q, n=n, n1=n1, n2=n2,
        f_a=NTT4Step(q, W1f.T, f_tw.T, r=n2),       # [B, k2, k1] → [B, k2, j1]
        f_b=NTT4Step(q, W2.T, None, r=n1),          # [B, j1, k2] → [B, j1, j2]
        g_a=NTT4Step(q, W2i.T, g_tw, r=n1),         # [B, j1, j2] → [B, j1, k2]
        g_b=NTT4Step(q, W1g.T, None, r=n2),         # [B, k2, j1] → [B, k2, k1]
    )


def fourstep_perm(tb: NTT4Tables) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm): ``natural[..., perm]`` is four-step order and
    ``fourstep[..., inv_perm]`` is natural order."""
    j1, j2 = np.meshgrid(np.arange(tb.n1), np.arange(tb.n2), indexing="ij")
    perm = (j2 * tb.n1 + j1).reshape(-1)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(tb.n)
    return perm, inv_perm


def modmul(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """Pointwise (a·b) mod q for residues in [0, q), int64: the product is
    below 2^60 and ``%`` on int64 is exact (no float, no shift chain)."""
    return a.to(torch.int64) * b % q


def transform_plain(x: torch.Tensor, tb: NTT4Tables,
                    inverse: bool) -> torch.Tensor:
    """K2's plain version on x's device: two ``ntt4_step_plain`` stages with
    the transposes between them. Forward: [B, N] natural order in, four-step
    order out; inverse: four-step order in, natural order out; canonical
    [0, q), int32."""
    bsz = x.shape[0]
    if not inverse:
        a = x.to(torch.int32).reshape(bsz, tb.n1, tb.n2)
        at = a.transpose(1, 2).contiguous()          # [B, k2, k1]
        y = ntt4_step_plain(at, tb.f_a)              # [B, k2, j1]
        yt = y.transpose(1, 2).contiguous()          # [B, j1, k2]
        return ntt4_step_plain(yt, tb.f_b).reshape(bsz, tb.n)
    a = x.to(torch.int32).reshape(bsz, tb.n1, tb.n2).contiguous()
    y = ntt4_step_plain(a, tb.g_a)                   # [B, j1, k2]
    yt = y.transpose(1, 2).contiguous()              # [B, k2, j1]
    z = ntt4_step_plain(yt, tb.g_b)                  # [B, k2, k1]
    return z.transpose(1, 2).reshape(bsz, tb.n)


def ntt4(x: torch.Tensor, tb: NTT4Tables, plain: bool = False) -> torch.Tensor:
    """Forward negacyclic NTT of [B, N] int32/int64 values (any value, taken
    as its residue mod q; int64 by its low 32 bits), four-step order output,
    canonical [0, q), int32. One K2 launch on the card; ``plain`` runs K2's
    plain version, to hold the kernel against."""
    if plain:
        return transform_plain(x, tb, False)
    return ntt4_transform(x.contiguous(), tb, False)


def intt4(x: torch.Tensor, tb: NTT4Tables, plain: bool = False) -> torch.Tensor:
    """Inverse of ntt4: consumes four-step order, emits natural order,
    canonical [0, q), int32."""
    if plain:
        return transform_plain(x, tb, True)
    return ntt4_transform(x.contiguous(), tb, True)
