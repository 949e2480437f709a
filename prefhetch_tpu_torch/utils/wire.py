"""Binary array wire helpers: base64 little-endian payloads + shape.

Copy of prefhetch_tpu/utils/wire.py.

The reference moves floats as JSON text (reference: Query.cc:53-56 via
nlohmann::json) — acceptable at its 10K scale, ruinous for ciphertext
tensors. Net-new routes carry fixed-dtype arrays as one base64 blob."""

from __future__ import annotations

import base64

import numpy as np


def pack_i32(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a, dtype="<i4")
    return {"b64": base64.b64encode(a.tobytes()).decode(), "shape": list(a.shape)}


def unpack_i32(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj["b64"])
    a = np.frombuffer(raw, dtype="<i4")
    shape = [int(s) for s in obj["shape"]]
    if a.size != int(np.prod(shape)):
        raise ValueError("wire array size does not match declared shape")
    return a.reshape(shape).astype(np.int32)
