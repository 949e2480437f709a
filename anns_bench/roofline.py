"""Peaks of the card and the work each per-layer roofline counts.

The work is that of a stage's contract, not of today's kernels: every input
byte read once and every returned output byte written once, so a redesign
that stops writing an intermediate reads the same work. Copied arithmetic:
``bound_s`` is chip_smoke.py's ``HBM_BYTES_S`` / peak rule (the larger of
bytes over bandwidth and operations over the peak); the byte counts are this
benchmark's own (chip_smoke.py ``k1_bound`` also counts K1's [nq, U·T]
distance write, an intermediate the stage never returns).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12


def bound_s(nbytes: float, flops: float = 0.0,
            flops_peak: float = BF16_FLOPS) -> Tuple[float, str]:
    """(least seconds the card could take, "bytes" or "flops": which bound);
    the rule of chip_smoke.py's bounds (``k1_bound``, ``slab_bound``)."""
    tb = nbytes / HBM_BYTES_S
    tf = flops / flops_peak if flops else 0.0
    return (tb, "bytes") if tb >= tf else (tf, "flops")


def scan_work(tile_sizes: np.ndarray, union: np.ndarray, pos: np.ndarray,
              d: int, tile: int, j_keep: int,
              payload_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, flops) of one pruned union scan call
    (ops/union_scan.py ``union_scan_pruned_fused``).

    Inputs read once: the valid payload rows of the union's tiles with
    their f32 norms, the union's ``sizes`` entries, ``union``, ``pos`` and
    the f32 queries. Outputs written once: ``dist`` [nq, j·T] bf16 and
    ``sel`` [nq, j] int64. FLOPs: 2·d for every row of each query's own
    probed tiles. ``tile_sizes`` are the valid rows of every tile, ``union``
    the call's tile ids [U], ``pos`` its positions [nq, mt] into the union.
    Written for this benchmark; chip_smoke.py ``k1_bound`` counted K1's
    intermediate [nq, U·T] write instead of the returned outputs."""
    union = np.asarray(union, np.int64)
    pos = np.asarray(pos, np.int64)
    nq, mt = pos.shape
    usz = np.asarray(tile_sizes, np.int64)[union]          # [U]
    rows_in = int(usz.sum())
    rows_q = int(usz[pos].sum())
    nbytes = (rows_in * (payload_bytes * d + 4) + 4 * len(union)
              + 4 * len(union) + 4 * nq * mt + 4 * nq * d
              + 2 * nq * j_keep * tile + 8 * nq * j_keep)
    return float(nbytes), float(2 * d * rows_q)


def ntt_work(batch: int, n: int, in_itemsize: int, n1: int, n2: int) -> float:
    """Bytes of one negacyclic transform call of [batch, n] residues
    (ops/ntt4.py ``ntt4`` / ``intt4``): the input once, the int32 output
    once, and the four-step tables once (two square matrices of residues,
    n1² and n2², and the n1·n2 twiddles, int32). Copied from chip_smoke.py's
    K2 byte count, with the twiddles as n int32 residues where that count
    takes the kernel's own 8-byte packed form."""
    return float(batch * n * in_itemsize + batch * n * 4
                 + 4 * (n1 * n1 + n2 * n2 + n1 * n2))
