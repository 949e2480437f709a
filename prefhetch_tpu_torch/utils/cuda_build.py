"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/lib<name>-<hash>.so`` for Hopper (``sm_90a``). The hash covers the
source and the flags, so an edited source never loads a stale library. The
build happens at first use and in no module import; ``build`` starts one
nvcc per source, all at once, so a script that needs every kernel pays for
the slowest compile only.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named kernel not built yet, one nvcc each, all started
    together. Returns {name: {"path", "seconds", "log"}} (log = nvcc's
    output, with ptxas's register and shared-memory report); raises with
    nvcc's output if any compile fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": "cached"}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {
            "path": path, "seconds": time.perf_counter() - t0, "log": log,
        }
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


@contextlib.contextmanager
def substituted(name: str, path) -> Iterator[ctypes.CDLL]:
    """Within the block, ``load(name)`` returns the library at ``path``
    instead (a build of an edited copy of the source); after it, what it
    returned before."""
    with _lock:
        before = _loaded.get(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    try:
        yield lib
    finally:
        with _lock:
            if before is None:
                _loaded.pop(name, None)
            else:
                _loaded[name] = before


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
