"""fvecs/ivecs dataset IO.

The data contract of the reference's ``vecs_read<T>`` loader (reference:
include/common/client_server_utils.h:24-56): TEXMEX-style .fvecs/.ivecs files
where every row is a little-endian int32 dimension header followed by ``d``
4-byte payload values (float32 for fvecs, int32 for ivecs). The reference
strips the per-row headers in place with memmove; here the native reader
(native/host_lib.cpp, ``native.read_vecs_native``) copies the payload out of
a memory-mapped file and checks every row's header.

The port of prefhetch_tpu/data/io.py: the file's size and first header are
checked up front with the reference's messages, then the native reader
copies; it has no numpy fallback.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from prefhetch_tpu_torch import native


def _read_vecs(path: str, dtype: np.dtype) -> np.ndarray:
    """Read a .fvecs/.ivecs file into an (n, d) array of ``dtype``."""
    if not os.path.exists(path):
        # reference aborts on unreadable dataset (client_server_utils.h:28-32)
        raise FileNotFoundError(f"could not open {path}")
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path}: empty vecs file")
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype="<i4", count=1)
    d = int(header[0])
    # same sanity guards as the reference (client_server_utils.h:36,41)
    if not (0 < d < 1_000_000):
        raise ValueError(f"{path}: incorrect dimensions d={d}")
    row_bytes = (d + 1) * 4
    if size % row_bytes != 0:
        raise ValueError(f"{path}: incorrect file size {size} for d={d}")
    # the native reader checks every row's header (error -5 when one
    # differs) and copies the payloads
    base = np.float32 if dtype == np.float32 else np.int32
    return native.read_vecs_native(path, base).astype(dtype, copy=False)


def read_fvecs(path: str) -> np.ndarray:
    """Read float vectors; returns (n, d) float32."""
    return _read_vecs(path, np.dtype(np.float32))


def read_ivecs(path: str) -> np.ndarray:
    """Read int vectors (e.g. ground-truth neighbor ids); returns (n, d) int32."""
    return _read_vecs(path, np.dtype(np.int32))


def vecs_read(path: str) -> Tuple[int, int, np.ndarray]:
    """Reference-shaped API: returns (d, n, flat_data).

    Mirrors ``vecs_read(fname, d_out, n_out, vecs)``
    (reference: include/common/client_server_utils.h:24-56).
    """
    arr = read_fvecs(path) if path.endswith(".fvecs") else read_ivecs(path)
    n, d = arr.shape
    return d, n, arr.reshape(-1)


def _write_vecs(path: str, arr: np.ndarray, payload_dtype: str) -> None:
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError("expected (n, d) array")
    n, d = arr.shape
    rows = np.empty((n, d + 1), dtype="<i4")
    rows[:, 0] = d
    rows[:, 1:] = arr.astype(payload_dtype, copy=False).view("<i4")
    with open(path, "wb") as f:
        rows.tofile(f)


def write_fvecs(path: str, arr: np.ndarray) -> None:
    _write_vecs(path, arr, "<f4")


def write_ivecs(path: str, arr: np.ndarray) -> None:
    _write_vecs(path, arr, "<i4")
