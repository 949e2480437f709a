"""The binary wire container, client side.

Frozen copy of prefhetch_tpu_torch/utils/wire_bin.py (``encode``,
``decode`` and the route kinds the traffic uses). Layout: u32 magic "PFB1",
u8 kind, u8 n_sections, u16 reserved; per section u8 dtype code, u8 ndim,
u16 reserved, u32 dims[ndim], padding to 8 bytes, the raw C-order data
padded to 8 bytes. Little-endian throughout.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

CONTENT_TYPE = "application/x-prefhetch-bin"
MAGIC = 0x31424650  # "PFB1"

KIND_CENTROIDS = 6         # GET /query: centroids f32 [nlist, d]
KIND_COARSE_TOPK_REQ = 9   # q f32 [nq, d], probes i64 [nq, nprobe], k u32 [1]
KIND_COARSE_TOPK = 10      # ids i32 [nq, k], dists f32 [nq, k], counts i64
KIND_SEARCH_REQ = 11       # /search: q f32 [nq, d], probes i64, k u32 [1]
KIND_SEARCH = 12           # ids i64 [nq, k], dists f32 [nq, k]

_DTYPES = {
    0: np.dtype(np.uint8),
    1: np.dtype(np.int32),
    2: np.dtype(np.int64),
    3: np.dtype(np.float32),
    4: np.dtype(np.uint16),
    5: np.dtype(np.float16),
    6: np.dtype(np.uint32),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def _align8(n: int) -> int:
    return (n + 7) & ~7


def encode(kind: int, sections: Sequence[np.ndarray]) -> bytes:
    """Pack arrays into one container (copy of wire_bin.encode)."""
    parts: List[bytes] = [struct.pack("<IBBH", MAGIC, kind, len(sections), 0)]
    total = 8
    for arr in sections:
        arr = np.ascontiguousarray(arr)
        hdr = struct.pack("<BBH", _DTYPE_CODES[arr.dtype], arr.ndim, 0)
        hdr += struct.pack(f"<{arr.ndim}I", *arr.shape)
        hdr += b"\0" * (_align8(total + len(hdr)) - (total + len(hdr)))
        parts.append(hdr)
        total += len(hdr)
        raw = arr.tobytes()
        pad = _align8(len(raw)) - len(raw)
        parts.append(raw + b"\0" * pad)
        total += len(raw) + pad
    return b"".join(parts)


def decode(buf: bytes) -> tuple[int, List[np.ndarray]]:
    """(kind, sections) of a container (copy of wire_bin.decode); raises
    ValueError on a malformed one."""
    if len(buf) < 8:
        raise ValueError("binary wire: truncated header")
    magic, kind, nsec, _ = struct.unpack_from("<IBBH", buf, 0)
    if magic != MAGIC:
        raise ValueError("binary wire: bad magic")
    off = 8
    out: List[np.ndarray] = []
    mv = memoryview(buf)
    for _ in range(nsec):
        if off + 4 > len(buf):
            raise ValueError("binary wire: truncated section header")
        code, ndim, _ = struct.unpack_from("<BBH", buf, off)
        dims = struct.unpack_from(f"<{ndim}I", buf, off + 4)
        off = _align8(off + 4 + 4 * ndim)
        dt = _DTYPES[code]
        n = int(np.prod(dims, dtype=np.int64)) if ndim else 1
        nbytes = n * dt.itemsize
        if off + nbytes > len(buf):
            raise ValueError("binary wire: truncated section")
        out.append(np.frombuffer(mv[off: off + nbytes], dtype=dt).reshape(dims))
        off = _align8(off + nbytes)
    return kind, out
