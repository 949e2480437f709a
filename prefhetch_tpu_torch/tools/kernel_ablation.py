"""Where the time of kernels K2, K4 and K5 goes on the card: each source
rebuilt with one part taken out or one constant changed, timed beside the
unchanged source on the same inputs.

``python3 chip_smoke.py`` runs it on the main path's own inputs: K4 on the
first ``quant="sq8"`` batch, K5 on the first ``scan="slab"`` batch, K2 on
the forward transform at an encrypted request's shape. A variant that takes
a part out computes wrong results on purpose (it drops work); only its
device time is read, and the gap to the unchanged source is what that part
costs where nothing else hides it. A variant that changes a constant (the
pairs a block takes, K5's pieces of one tile or fixed chunks, blocks an SM,
ring depth) stays exact and is held against the plain version. The edits
are exact strings of the sources: ``apply_edits`` refuses one that does not
match once, and the CPU tests apply every edit to the current sources, so
an edit of a patched line fails there first.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict, List, Tuple

import torch

from prefhetch_tpu_torch.utils import cuda_build

Edits = List[Tuple[str, str]]
# timer(fn, kernel name) -> the mean device ms of one launch of that kernel
Timer = Callable[[Callable[[], object], str], float]

K4_VARIANTS: Dict[str, Edits] = {
    "no FMA": [(
        "          acc[i * NPP + j] = fmaf(x[i][k], q8[k], acc[i * NPP + j]);",
        "          ;")],
    "no decode": [(
        "        x[i][e] = decode(w.x, e);\n"
        "        x[i][4 + e] = decode(w.y, e);",
        "        x[i][e] = __uint_as_float(w.x);\n"
        "        x[i][4 + e] = __uint_as_float(w.y);")],
    "no code loads": [("        cp_async16(dst + i, src + i);", "        ;")],
    "no distance stores": [("&& j < NP && t < size)\n",
                            "&& j < NP && t < size && t < 0)\n")],
    "chunk 2": [("constexpr int CHUNK = 4;", "constexpr int CHUNK = 2;")],
    "chunk 8": [("constexpr int CHUNK = 4;", "constexpr int CHUNK = 8;")],
    "2 blocks an SM": [("__launch_bounds__(THREADS, 3)\nsq8_tiled_kernel",
                        "__launch_bounds__(THREADS, 2)\nsq8_tiled_kernel")],
    "4 blocks an SM": [("__launch_bounds__(THREADS, 3)\nsq8_tiled_kernel",
                        "__launch_bounds__(THREADS, 4)\nsq8_tiled_kernel")],
    "ring of 3": [("constexpr int NST = 4;", "constexpr int NST = 3;")],
    "ring of 6": [("constexpr int NST = 4;", "constexpr int NST = 6;")],
}

K5_VARIANTS: Dict[str, Edits] = {
    "no mma": [(
        "            mma_16816(c, a, b[ks][sp][0], b[ks][sp][1]);",
        "            c[0] += __uint_as_float(a[sp] ^ b[ks][sp][1]);")],
    "no payload loads": [(
        "        cp_async16(st + row * rs + c * 16, src + (size_t)v * 16);",
        "        ;")],
    "no distance stores": [("        if (t < size && j >= j0 && j < j1)\n",
                            "        if (t < size && j >= j0 && j < 0)\n")],
    "chunk 2": [("constexpr int SLAB_CHUNK = 8;",
                 "constexpr int SLAB_CHUNK = 2;")],
    "chunk 4": [("constexpr int SLAB_CHUNK = 8;",
                 "constexpr int SLAB_CHUNK = 4;")],
    "fixed chunks": [("constexpr bool SLAB_RUN_ALIGNED = true;",
                      "constexpr bool SLAB_RUN_ALIGNED = false;")],
    "3 blocks an SM": [("constexpr int SLAB_BLOCKS = 2;",
                        "constexpr int SLAB_BLOCKS = 3;")],
    "4 warps a block": [("constexpr int SLAB_WARPS = 8;",
                         "constexpr int SLAB_WARPS = 4;"),
                        ("constexpr int SLAB_BLOCKS = 2;",
                         "constexpr int SLAB_BLOCKS = 4;")],
    "ring of 3": [("constexpr int SLAB_NST = 2;",
                   "constexpr int SLAB_NST = 3;")],
}

K2_VARIANTS: Dict[str, Edits] = {
    "no mma": [(
        "          mma_s8(acc[d + e], af[d][ks], bf[e][ks][0], bf[e][ks][1]);",
        "          acc[d + e][0] += (int)(af[d][ks][0] ^ bf[e][ks][1]);")],
    "no recombination": [(
        "      v[i] = recombine(a, c);",
        "      v[i] = (uint32_t)(a[0] + a[1] + a[2] + a[3] + a[4] + a[5]"
        " + a[6]);")],
    "no input loads": [(
        "          split4(load_x(x, x64, base + (size_t)(4 * grp + s) * N2 "
        "+ col,\n                        c.q),",
        "          split4((uint32_t)(col * 977 + grp),")],
}

SOURCES = {"K4": ("slab_scan", K4_VARIANTS), "K5": ("slab_scan", K5_VARIANTS),
           "K2": ("ntt4_step", K2_VARIANTS)}


def apply_edits(text: str, edits: Edits, label: str) -> str:
    """``text`` with each (old, new) replaced; raises if an ``old`` does
    not occur exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{label}: the edit does not match the source "
                             f"once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(name: str, edits: Dict[str, Edits]) -> Dict[str, str]:
    """Every variant of csrc/<name>.cu, and the source unchanged, compiled
    at once (one nvcc each) into build/ablation/. Returns {variant: library
    path}."""
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    out_dir = cuda_build.BUILD / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, pairs in {"unchanged": [], **edits}.items():
        stem = out_dir / f"{name}-{len(procs)}"
        stem.with_suffix(".cu").write_text(
            apply_edits(src, pairs, f"{name}/{variant}"))
        so = stem.with_suffix(".so")
        procs[variant] = (str(so), subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for variant, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}/{variant}:\n{log}")
        libs[variant] = so
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def ablate_slab(k4args: tuple, k5args: tuple, timer: Timer,
                check: Callable[[str, str], object]
                ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """K4 (``slab_distances_sq8(*k4args)``) and K5 (``slab_distances(
    *k5args)``) under every variant of their shared source, built at once:
    ({variant: K4 ms}, {variant: K5 ms}), each with "unchanged".
    ``check(kernel, variant)`` holds an exact variant against the plain
    version while its library is the one loaded."""
    from prefhetch_tpu_torch.ops import slab_scan

    runs = {"K4": (lambda: slab_scan.slab_distances_sq8(*k4args),
                   "sq8_tiled_kernel"),
            "K5": (lambda: slab_scan.slab_distances(*k5args),
                   "slab_tiled_kernel")}
    edits = {f"{k} {v}": e for k, variants in (("K4", K4_VARIANTS),
                                               ("K5", K5_VARIANTS))
             for v, e in variants.items()}
    out: Dict[str, Dict[str, float]] = {"K4": {}, "K5": {}}
    for name, so in build_variants("slab_scan", edits).items():
        kernels = ("K4", "K5") if name == "unchanged" else (name[:2],)
        variant = "unchanged" if name == "unchanged" else name[3:]
        with cuda_build.substituted("slab_scan", so):
            for k in kernels:
                if not variant.startswith("no "):
                    check(k, variant)
                out[k][variant] = timer(*runs[k])
    return out["K4"], out["K5"]


def ablate_k2(tb, nbatch: int, timer: Timer,
              seed: int = 0) -> Dict[str, float]:
    """K2's forward transform of ``nbatch`` random int32 residues under
    ``tb`` (``ops/ntt4.build_ntt4_tables``) under every variant: {variant:
    ms}. The kernel's work does not depend on the values."""
    from prefhetch_tpu_torch.ops import ntt4

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, tb.q, (nbatch, tb.n), device="cuda",
                      dtype=torch.int32, generator=gen)
    out = {}
    for variant, so in build_variants("ntt4_step", K2_VARIANTS).items():
        with cuda_build.substituted("ntt4_step", so):
            out[variant] = timer(lambda: ntt4.ntt4(x, tb), "ntt4_kernel")
    return out
