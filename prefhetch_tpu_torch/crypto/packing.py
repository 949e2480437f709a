"""Coefficient packing: batched encrypted inner products via one ct×pt.

Copy of prefhetch_tpu/crypto/packing.py (numpy only).

The encrypted L2 re-rank (the protocol role the reference reserved for SEAL
— "will be sending coarse vector in a future implementation",
reference: include/client/client_lib.h:34-36) reduces to inner products:
        ‖q − x‖² = ‖q‖² − 2⟨q, x⟩ + ‖x‖²
where only ⟨q, x⟩ involves the secret query.

Packing trick (negacyclic convolution): encode the query as
q(X) = Σ_k q_k X^k. Pack B = N/d candidates into one plaintext poly with
candidate j's vector REVERSED in its d-aligned block:
        p(X) = Σ_j Σ_k x_j[d−1−k] · X^{j·d + k}.
Then coefficient j·d + (d−1) of q(X)·p(X) mod (X^N+1) equals ⟨q, x_j⟩
exactly (no wraparound: all contributing index sums stay below N, and
cross-candidate products land on other coefficients).

One ciphertext×plaintext product therefore scores N/d candidates
(N=4096, d=128 → 32 per MAC). Inner products must fit a centered plaintext
window |⟨q,x⟩| < t/2 (SIFT: 128·255² < 2^23 < t/2 at t=2^24+…), so BFV
decrypts them exactly; SIGNED integer data is supported via mod-t encoding
plus the centered lift in ``extract_inner_products``. Non-integer data
(e.g. unit-normalized cosine vectors) must be fixed-point quantized by the
caller first — both encoders reject it rather than rounding to garbage.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from prefhetch_tpu_torch.crypto.params import BFVParams


def candidates_per_block(params: BFVParams, d: int) -> int:
    assert params.n % d == 0
    return params.n // d


def plain_ints(x: np.ndarray, t: int, what: str) -> np.ndarray:
    """Validate integer-valued input with |x| < t/2; returns signed int64."""
    xi = np.round(x).astype(np.int64)
    if not np.allclose(np.asarray(x, np.float64), xi, atol=1e-6):
        raise ValueError(
            f"{what} must be integer-valued for the exact BFV path "
            "(got fractional values — fixed-point quantize first, e.g. "
            "scale cosine/unit vectors by 2^b and round)"
        )
    if np.abs(xi).max(initial=0) >= t // 2:
        raise ValueError(
            f"{what} magnitude {np.abs(xi).max()} exceeds the plaintext "
            f"half-window t/2 = {t // 2}"
        )
    return xi


def encode_query_poly(q: np.ndarray, params: BFVParams) -> np.ndarray:
    """Query vector [d] (signed ints, |q| < t/2) → plaintext poly [N].

    This is the ENCRYPTED message: signed values lift into [0, t) — the
    message magnitude does not multiply encryption noise."""
    d = q.shape[0]
    out = np.zeros(params.n, np.int64)
    out[:d] = plain_ints(q, params.t, "query") % params.t
    return out


def pack_candidate_block(x_block: np.ndarray, params: BFVParams) -> np.ndarray:
    """Candidate matrix [B, d] (B ≤ N/d) → packed plaintext poly [N].

    Candidate j occupies coefficients [j·d, (j+1)·d) with reversed order.

    This is the ct×pt MULTIPLICAND: values stay as SMALL SIGNED ints (the
    per-limb ``% q`` inside the NTT reduces them); lifting mod t here would
    scale ciphertext noise by ~t and break decryption."""
    B, d = x_block.shape
    assert B * d <= params.n
    out = np.zeros(params.n, np.int64)
    rev = plain_ints(x_block[:, ::-1], params.t, "candidates")  # [B, d]
    out[: B * d] = rev.reshape(-1)
    return out


def pack_candidates(
    x: np.ndarray, params: BFVParams
) -> Tuple[np.ndarray, int]:
    """[P, d] candidates → ([n_blocks, N] packed polys, B per block).

    P is padded with zero vectors to a multiple of N/d."""
    P, d = x.shape
    B = candidates_per_block(params, d)
    n_blocks = -(-P // B)
    padded = np.zeros((n_blocks * B, d), x.dtype)
    padded[:P] = x
    polys = np.stack(
        [pack_candidate_block(padded[i * B : (i + 1) * B], params)
         for i in range(n_blocks)]
    )
    return polys, B


def extract_inner_products(
    product_coeffs: np.ndarray, d: int, n_candidates: int,
    t: Optional[int] = None,
) -> np.ndarray:
    """Decrypted product polys [n_blocks, N] → inner products [n_candidates].

    Inner product of candidate j in block b sits at coefficient j·d + d−1.
    With ``t`` given, coefficients are center-lifted from [0, t) to
    (−t/2, t/2] so negative inner products (signed data) decode correctly."""
    n_blocks, n = product_coeffs.shape
    B = n // d
    idx = np.arange(B) * d + (d - 1)
    vals = product_coeffs[:, idx].reshape(-1)             # [n_blocks·B]
    vals = vals[:n_candidates]
    if t is not None:
        vals = np.where(vals > t // 2, vals - t, vals)
    return vals


def distances_from_inner_products(
    q: np.ndarray, ips: np.ndarray, x_norms: np.ndarray
) -> np.ndarray:
    """‖q‖² − 2⟨q,x⟩ + ‖x‖² (client-side final assembly)."""
    qsq = float(np.sum(np.round(q).astype(np.int64) ** 2))
    return qsq - 2.0 * ips.astype(np.float64) + x_norms.astype(np.float64)
