"""ctypes bindings to the port's host C++ libraries — the port of
prefhetch_tpu/native/__init__.py.

Three libraries, each built from a source in this directory:

- ``host_lib.cpp``: the fvecs/ivecs reader and the negacyclic NTT with
  Shoup multiplication (a copy of sections 1 and 3 of
  native/prefhetch_native.cpp that takes any int64 residue), under every
  host transform of the port (crypto/ntt.py) and its dataset reader
  (data/io.py);
- ``json_codec.cpp``: the JSON number-array codec (a copy of section 2 of
  native/prefhetch_native.cpp), which writes the ragged ``/coarsesearch``
  response (~10^4-10^5 numbers a query) and the other number arrays of the
  JSON wire, and decodes them on the client;
- ``pfh_http.cpp``: the epoll HTTP/1.1 frontend (a copy of
  native/pfh_http.cpp) that serve/native_server.py drives.

Each is compiled with g++ at first use into the package's gitignored
``build/`` as ``lib<name>-<hash>.so``, as utils/cuda_build.py names the
CUDA kernels. The flags are the JAX loader's, ``-march=native`` included
(the codec's float formatting must round as the JAX package's build does),
so the hash covers the source, the flags and this host's CPU: a library
built on one machine is never loaded on another. Two differences from the
JAX loader, both on purpose:

- a build holds an exclusive ``fcntl.flock`` on ``build/<name>.lock``,
  compiles to a temporary name and ``os.replace``s the result into place, so
  processes that build at once (test workers) never load a half-written
  file;
- a failed build raises with the compiler's output; nothing returns None and
  nothing carries on without the library (there is no ``PFH_NO_NATIVE``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD = SRC.parent / "build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread"]
HOST, CODEC, HTTP = "host_lib", "json_codec", "pfh_http"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _cpu_id() -> str:
    """The CPU's model and feature flags (what -march=native compiles
    for), or the machine type where /proc/cpuinfo is absent."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags") and key not in info:
                    info[key] = value.strip()
    except OSError:
        pass
    return platform.machine() + "|" + "|".join(sorted(info.values()))


def library_path(name: str, build_dir: Path = BUILD) -> Path:
    h = hashlib.sha256((SRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS + [_cpu_id()]).encode())
    return Path(build_dir) / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, build_dir: Path = BUILD) -> Path:
    """Compile ``name``.cpp unless this source was built already with these
    flags for this CPU; returns the library's path. Raises RuntimeError
    with g++'s output when the build fails."""
    path = library_path(name, build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():                 # another process built it
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SRC / f"{name}.cpp"), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"cannot build {name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed to build {name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def _load(name: str, bind) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _libs[name] = lib
        return lib


# ---------------------------------------------------------------------------
# vecs reader and host NTT
# ---------------------------------------------------------------------------
def _bind_host(lib: ctypes.CDLL) -> None:
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.pfh_vecs_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                    ctypes.POINTER(i64)]
    lib.pfh_vecs_header.restype = ctypes.c_int
    lib.pfh_vecs_read.argtypes = [ctypes.c_char_p, vp, i64, i64]
    lib.pfh_vecs_read.restype = ctypes.c_int
    lib.pfh_ntt_batch.argtypes = [vp, i64, i64, i64, vp, vp, vp, vp, vp,
                                  ctypes.c_int, ctypes.c_int]
    lib.pfh_ntt_batch.restype = None
    lib.pfh_pointwise_mulmod.argtypes = [vp, vp, vp, vp, i64, i64]
    lib.pfh_pointwise_mulmod.restype = None


def host_lib() -> ctypes.CDLL:
    """The vecs-reader and host-NTT library, built on first use."""
    return _load(HOST, _bind_host)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def read_vecs_native(path: str, dtype) -> np.ndarray:
    """Read a .fvecs/.ivecs file into an [n, d] array of ``dtype`` (a 4-byte
    type: float32 or int32), the per-row headers checked and stripped. A
    native error code raises ValueError naming it."""
    lib = host_lib()
    d, n = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.pfh_vecs_header(path.encode(), ctypes.byref(d), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"{path}: native header error {rc}")
    out = np.empty((n.value, d.value), dtype=dtype)
    rc = lib.pfh_vecs_read(path.encode(), _ptr(out), n.value, d.value)
    if rc != 0:
        raise ValueError(f"{path}: native read error {rc}")
    return out


def shoup(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w·2^64 / q) for residues w in [0, q), q < 2^31, as the int64
    bit pattern the C side reads as uint64. Two exact int64 divisions:
    ⌊w·2^32/q⌋·2^32 + ⌊(w·2^32 mod q)·2^32/q⌋."""
    if not 1 < q < 1 << 31:
        raise ValueError(f"Shoup constants need 1 < q < 2^31, got {q}")
    w = np.asarray(w, np.int64)
    hi, r = np.divmod(w << 32, q)
    lo = (r << 32) // q
    return ((hi.astype(np.uint64) << np.uint64(32))
            + lo.astype(np.uint64)).view(np.int64)


class NativeNTT:
    """Shoup-multiplication negacyclic NTT (threaded) for one prime: the
    forward transform, or the inverse with ``inverse=True``, of ``tables``
    (crypto/ntt.NTTTables). Any int64 value is taken as its residue mod q;
    the output is canonical int64 in the input's shape, and the input is
    never written. A call keeps no state, so threads may share one."""

    def __init__(self, tables, inverse: bool = False):
        q = tables.q
        self.q, self.n, self.inverse = q, tables.n, inverse
        tw = np.concatenate(tables.stage_itw if inverse else tables.stage_tw)
        psi = tables.ipsi_pows if inverse else tables.psi_pows
        self.tw = np.ascontiguousarray(tw, np.int64)
        self.tw_sh = shoup(self.tw, q)
        self.psi = np.ascontiguousarray(psi, np.int64)
        self.psi_sh = shoup(self.psi, q)
        self.bitrev = np.ascontiguousarray(tables.bitrev, np.int64)
        self.n_threads = min(4, os.cpu_count() or 1)
        self._lib = host_lib()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.shape[-1:] != (self.n,):
            raise ValueError(f"NTT of length {self.n} over the last axis, "
                             f"got shape {x.shape}")
        out = np.array(x, np.int64, order="C")          # a copy, always
        self._lib.pfh_ntt_batch(
            _ptr(out), out.size // self.n, self.n, self.q,
            _ptr(self.psi), _ptr(self.psi_sh), _ptr(self.tw),
            _ptr(self.tw_sh), _ptr(self.bitrev),
            0 if self.inverse else 1,   # twist_first: fwd twists before
            self.n_threads,
        )
        return out


def pointwise_mulmod(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """(a·b) mod q elementwise, int64 in a's shape: a any int64, b taken as
    its residue (Shoup constants of b mod q)."""
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(np.broadcast_to(np.asarray(b, np.int64) % q,
                                             a.shape))
    b_sh = shoup(b, q)
    out = np.empty_like(a)
    host_lib().pfh_pointwise_mulmod(_ptr(out), _ptr(a), _ptr(b), _ptr(b_sh),
                                    a.size, q)
    return out


# ---------------------------------------------------------------------------
# JSON number-array codec
# ---------------------------------------------------------------------------
def _bind_codec(lib: ctypes.CDLL) -> None:
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    for fn in (lib.pfh_json_encode_f32, lib.pfh_json_encode_i64):
        fn.argtypes = [vp, i64, ctypes.c_char_p, i64]
        fn.restype = i64
    lib.pfh_json_decode_f64.argtypes = [ctypes.c_char_p, i64, vp, i64]
    lib.pfh_json_decode_f64.restype = i64


def codec_lib() -> ctypes.CDLL:
    """The codec library, built on first use."""
    return _load(CODEC, _bind_codec)


def _encode(fn_name: str, x: np.ndarray) -> bytes:
    cap = x.size * 26 + 32
    buf = ctypes.create_string_buffer(cap)
    n = getattr(codec_lib(), fn_name)(
        x.ctypes.data_as(ctypes.c_void_p), x.size, buf, cap)
    if n < 0:
        raise RuntimeError(f"{fn_name}: output overran {cap} bytes")
    return buf.raw[:n]


def json_encode_f32(x: np.ndarray) -> bytes:
    """Flat float array → JSON array bytes (f32 round-trip precision)."""
    return _encode("pfh_json_encode_f32", np.ascontiguousarray(x, np.float32))


def json_encode_i64(x: np.ndarray) -> bytes:
    return _encode("pfh_json_encode_i64", np.ascontiguousarray(x, np.int64))


def json_encode_f32_nested(x: np.ndarray) -> bytes:
    """N-D float array → nested JSON array bytes, the JAX loader's bytes
    (each trailing-axis row as the codec writes it, outer axes as JSON
    nesting). The whole array is encoded in one codec call and the commas
    at row boundaries become the brackets, where the JAX loader makes one
    call, and one ctypes round trip, a row."""
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim == 1:
        return json_encode_f32(x)
    if x.size == 0:
        return b"[" + b",".join(json_encode_f32_nested(r) for r in x) + b"]"
    flat = json_encode_f32(x.reshape(-1))          # "[v0,v1,...]"
    m = x.shape[-1]
    rows = x.size // m
    # comma i follows element i; a row ends at element k·m − 1
    commas = np.flatnonzero(np.frombuffer(flat, np.uint8) == ord(","))
    k = np.arange(1, rows)
    cuts = commas[k * m - 1]
    depth = np.ones(rows - 1, np.int64)            # axes that close there
    span = 1
    for n in reversed(x.shape[1:-1]):
        span *= n
        depth += k % span == 0
    seps = {d: b"]" * d + b"," + b"[" * d for d in range(1, x.ndim + 1)}
    out = [b"[" * (x.ndim - 1)]
    prev = 0
    for c, d in zip(cuts.tolist(), depth.tolist()):
        out.append(flat[prev:c])
        out.append(seps[d])
        prev = c + 1
    out.append(flat[prev:])
    out.append(b"]" * (x.ndim - 1))
    return b"".join(out)


def json_decode_array(buf: bytes, start: int = 0) -> Optional[np.ndarray]:
    """Decode the JSON number array beginning at buf[start] ('[...]') into
    float64; None if the input is malformed."""
    seg = buf[start:]
    # every element costs ≥2 bytes (digit + separator) → safe count bound
    cap = len(seg) // 2 + 2
    out = np.empty(cap, np.float64)
    n = codec_lib().pfh_json_decode_f64(
        seg, len(seg), out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return out[:n]


def json_decode_field(body: bytes, key: str) -> Optional[np.ndarray]:
    """Decode the flat JSON number array at `"key": [...]` inside a JSON
    object body, without parsing the rest of the object. None when the key
    is absent or the structure is unexpected (callers parse with json)."""
    marker = b'"' + key.encode() + b'"'
    pos = body.find(marker)
    if pos < 0:
        return None
    pos = body.find(b":", pos + len(marker))
    if pos < 0:
        return None
    pos += 1
    while pos < len(body) and body[pos : pos + 1] in b" \t\r\n":
        pos += 1
    if pos >= len(body) or body[pos : pos + 1] != b"[":
        return None
    return json_decode_array(body, pos)


# ---------------------------------------------------------------------------
# epoll HTTP frontend
# ---------------------------------------------------------------------------
_PATH_MAX = 120   # keep in sync with pfh_http.cpp kPathMax


class ReqDesc(ctypes.Structure):
    """Mirror of pfh_http.cpp ReqDesc."""

    _fields_ = [
        ("req_id", ctypes.c_uint64),
        ("body", ctypes.POINTER(ctypes.c_uint8)),
        ("body_len", ctypes.c_uint64),
        ("method", ctypes.c_char * 8),
        ("path", ctypes.c_char * _PATH_MAX),
        ("flags", ctypes.c_uint8),
    ]


def _bind_http(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.pfh_http_start.argtypes = [ctypes.c_uint16, ctypes.c_int]
    lib.pfh_http_start.restype = vp
    lib.pfh_http_poll.argtypes = [
        vp, ctypes.POINTER(ReqDesc), ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.pfh_http_poll.restype = ctypes.c_int
    lib.pfh_http_respond.argtypes = [
        vp, ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.pfh_http_respond.restype = None
    lib.pfh_http_respond_multi.argtypes = [
        vp, ctypes.c_int, vp, vp, ctypes.c_int, vp, vp,
    ]
    lib.pfh_http_respond_multi.restype = None
    lib.pfh_http_port.argtypes = [vp]
    lib.pfh_http_port.restype = ctypes.c_uint16
    lib.pfh_http_stop.argtypes = [vp]
    lib.pfh_http_stop.restype = None


def http_lib() -> ctypes.CDLL:
    """The epoll-frontend library, built on first use."""
    return _load(HTTP, _bind_http)
