"""The work the PIR fetch's per-layer rooflines count, from the shapes of
the deployment (configs/sift1m-pir.json) and the program's counters.

As roofline.py counts, the work is that of a stage's contract: every input
byte read once and every output byte written once, whatever today's
kernels read again.
"""

from __future__ import annotations

from typing import Tuple


def fold1_bytes(programs: int, selector_sets: int, g1: int, g2: int,
                n_limbs: int, n: int) -> float:
    """Bytes of the dim-1 fold (engine/pir_device.py ``_fold_dim1``):
    each program reads the NTT-domain database [G1, G2, L, N] int32 once;
    each selector set reads its G1 selector ciphertexts [G1, 2, L, N] int32
    once and writes its G2 column sums [2, G2, L, N] once, as canonical
    residues below q < 2^30 in int32 (chip_smoke.py's count of the fold's
    bound)."""
    poly = n_limbs * n * 4
    return float(programs * g1 * g2 * poly
                 + selector_sets * (g1 * 2 + 2 * g2) * poly)


def ntt_tables(n: int) -> Tuple[int, int]:
    """(n1, n2) of the four-step split (ops/ntt4.py ``build_ntt4_tables``)."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def k2_bytes(rows_i32: int, rows_i64: int, launches: int, n: int) -> float:
    """Bytes of K2's launches (ops/ntt4.py ``ntt4``/``intt4``) summed as
    roofline.ntt_work counts one: each row's input once (4 or 8 bytes a
    residue), its int32 output once, and the four-step tables once a
    launch."""
    n1, n2 = ntt_tables(n)
    return float(rows_i32 * n * (4 + 4) + rows_i64 * n * (8 + 4)
                 + launches * 4 * (n1 * n1 + n2 * n2 + n1 * n2))
