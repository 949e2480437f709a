"""The benchmark's settings, data and indexes, and its two numpy references
(bench.py :94-197, :485-518 and :1200-1219).

``BenchConfig.from_env`` reads bench.py's variables with bench.py's
defaults. The three datasets come from the port's generators with bench.py's
seeds and shapes, so the same ``PFH_BENCH_NBASE`` gives the same arrays as
bench.py; they and their indexes are cached as npz under ``cache``
(``bench_cache/torch/`` by default). ``numpy_pipeline`` and
``ivf_oracle_topk`` are numpy only: the plain references the benchmark holds
the device's answers to.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, FrozenSet, Optional

import numpy as np
import torch

from prefhetch_tpu_torch.data.synthetic import (
    make_clustered_dataset, make_hard_dataset, normalize_rows,
)
from prefhetch_tpu_torch.index.build import (
    build_ivf_index, load_index, save_index,
)
from prefhetch_tpu_torch.index.types import IVFIndex
from prefhetch_tpu_torch.utils.config import IndexParams

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE = os.path.join(ROOT, "bench_cache", "torch")

# operating point: BASELINE.json's SIFT1M configuration
D = 128
PQ_M = 32
NPROBE = 16
COARSE_PROBE = 256
K = 100
BATCH = 64          # protocol/serving batch (recall scoring, HTTP bench)
NQ_POOL = 512       # distinct query pool for throughput batching
N_BATCHES = 20

# the sections after the headline, in bench.py's order, with the variable
# that leaves each out
SECTIONS = (
    ("encrypted", "PFH_BENCH_SKIP_ENC"),
    ("http", "PFH_BENCH_SKIP_HTTP"),
    ("ckks", "PFH_BENCH_SKIP_CKKS"),
    ("pq", "PFH_BENCH_SKIP_PQ"),
    ("pir", "PFH_BENCH_SKIP_PIR"),
    ("angular", "PFH_BENCH_SKIP_ANGULAR"),
    ("hard", "PFH_BENCH_SKIP_HARD"),
)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One run's settings; ``from_env`` reads bench.py's variables."""

    nbase: int = 1_000_000          # PFH_BENCH_NBASE
    dev_batch: int = 256            # PFH_BENCH_BATCH: queries a step
    quant: str = "none"             # PFH_BENCH_QUANT: none | sq8 | pq
    scan: str = "union"             # PFH_BENCH_SCAN: union | slab
    tile: Optional[int] = None      # PFH_BENCH_TILE (None: 256 pq, else 1024)
    prune_j: Optional[int] = None   # PFH_BENCH_PRUNE_J (None: 24 a 256 CP)
    deadline_s: float = 720.0       # PFH_BENCH_DEADLINE_S
    skip: FrozenSet[str] = frozenset()   # PFH_BENCH_SKIP_*
    pir_full: bool = False          # PFH_BENCH_PIR_FULL
    cache: str = DEFAULT_CACHE

    @property
    def ntrain(self) -> int:
        return min(self.nbase, 100_000)

    @property
    def nlist(self) -> int:
        return 1024 if self.nbase >= 500_000 else 512

    def tile_for(self, quant: str) -> int:
        """256-slot tiles for the PQ codes payload, else 1024."""
        if self.tile is not None:
            return self.tile
        return 256 if quant == "pq" else 1024

    def index_params(self) -> IndexParams:
        return IndexParams(d=D, nlist=self.nlist, pq_m=PQ_M, pq_nbits=8)

    @classmethod
    def from_env(cls, cache: Optional[str] = None) -> "BenchConfig":
        environ = os.environ

        def opt_int(name):
            v = environ.get(name)
            return None if v is None else int(v)

        return cls(
            nbase=int(environ.get("PFH_BENCH_NBASE", 1_000_000)),
            dev_batch=int(environ.get("PFH_BENCH_BATCH", 256)),
            quant=environ.get("PFH_BENCH_QUANT", "none"),
            scan=environ.get("PFH_BENCH_SCAN", "union"),
            tile=opt_int("PFH_BENCH_TILE"),
            prune_j=opt_int("PFH_BENCH_PRUNE_J"),
            deadline_s=float(environ.get("PFH_BENCH_DEADLINE_S", 720)),
            skip=frozenset(name for name, var in SECTIONS
                           if environ.get(var)),
            pir_full=bool(environ.get("PFH_BENCH_PIR_FULL")),
            cache=cache or DEFAULT_CACHE,
        )


def _cached(path: str, make) -> Dict[str, np.ndarray]:
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    data = make()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **data)
    os.replace(tmp, path)
    return data


def get_dataset(cfg: BenchConfig) -> Dict[str, np.ndarray]:
    """The headline's clustered SIFT-style set (seed 20) with NQ_POOL
    queries and exact ground truth."""
    return _cached(
        os.path.join(cfg.cache, f"ds_{cfg.nbase}_{D}_q{NQ_POOL}.npz"),
        lambda: make_clustered_dataset(
            nbase=cfg.nbase, ntrain=cfg.ntrain, nquery=NQ_POOL, d=D,
            n_clusters=600, gt_k=100, seed=20,
        ),
    )


def get_hard_dataset(cfg: BenchConfig) -> Dict[str, np.ndarray]:
    """Overlapping heavy-tailed workload where IVF recall is genuinely below
    1 (seed 21, BATCH queries; data.synthetic.make_hard_dataset)."""
    return _cached(
        os.path.join(cfg.cache, f"ds_hard_{cfg.nbase}_{D}.npz"),
        lambda: make_hard_dataset(
            nbase=cfg.nbase, ntrain=cfg.ntrain, nquery=BATCH, d=D,
            n_clusters=600, gt_k=100, seed=21,
        ),
    )


def get_angular_dataset(cfg: BenchConfig) -> Dict[str, np.ndarray]:
    """Unit-normalised heavy-tailed workload (GloVe-like angular search):
    the hard generator (seed 22), rows projected to the unit sphere, ground
    truth the exact angular (max cosine) neighbours."""
    def make():
        data = make_hard_dataset(
            nbase=cfg.nbase, ntrain=cfg.ntrain, nquery=BATCH, d=D,
            n_clusters=600, gt_k=100, seed=22,
        )
        out = {k: normalize_rows(data[k]) for k in ("base", "train", "query")}
        # exact angular ground truth (on the sphere, max cosine == min L2)
        gt = np.empty((len(out["query"]), 100), np.int32)
        for i, q in enumerate(out["query"]):
            sims = out["base"] @ q
            gt[i] = np.argsort(-sims, kind="stable")[:100]
        out["groundtruth"] = gt
        return out

    return _cached(os.path.join(cfg.cache, f"ds_ang_{cfg.nbase}_{D}.npz"),
                   make)


def get_index(cfg: BenchConfig, data: Dict[str, np.ndarray],
              device: torch.device, subdir: str = "") -> IVFIndex:
    """The IVF1024/512 + PQ32x8 index of ``data``, built on ``device`` and
    cached. The cache name carries the base's size: the artifact name holds
    the geometry only, and two sizes can share an nlist."""
    params = cfg.index_params()
    cache = os.path.join(cfg.cache, subdir) if subdir else cfg.cache
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"N{len(data['base'])}_"
                        + params.artifact_name())
    if os.path.exists(path):
        idx = load_index(path, device)
        if idx.ntotal == len(data["base"]) and idx.params == params:
            return idx
    idx = build_ivf_index(data["train"], data["base"], params, device)
    os.replace(save_index(idx, cache), path)
    return idx


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def numpy_pipeline(index: IVFIndex, base: np.ndarray, nprobe: int = NPROBE,
                   coarse_probe: int = COARSE_PROBE, k: int = K):
    """Single-thread numpy baseline of the same pipeline, ADC on the PQ
    codes: returns run(queries [nq, d]) -> ids [nq, k]."""
    centroids = _host(index.centroids)
    list_codes = _host(index.list_codes)
    list_ids = _host(index.list_ids)
    list_sizes = _host(index.list_sizes)
    codebooks = _host(index.codebooks)
    M, ksub, dsub = codebooks.shape

    def run(q_batch):
        out_ids = []
        for q in q_batch:
            d2c = ((centroids - q) ** 2).sum(-1)
            probes = np.argsort(d2c)[:nprobe]
            dists, ids = [], []
            for p in probes:
                r = q - centroids[p]
                rs = r.reshape(M, dsub)
                lut = ((rs[:, None, :] - codebooks) ** 2).sum(-1)  # [M, ksub]
                n = list_sizes[p]
                codes = list_codes[p, :n]                          # [n, M]
                d = lut[np.arange(M)[None, :], codes].sum(-1)
                dists.append(d)
                ids.append(list_ids[p, :n])
            dists = np.concatenate(dists)
            ids = np.concatenate(ids)
            top = np.argsort(dists)[:coarse_probe]
            cand = ids[top]
            pd = ((base[cand] - q) ** 2).sum(-1)
            out_ids.append(cand[np.argsort(pd)[:k]])
        return np.stack(out_ids)

    return run


def ivf_oracle_topk(data: Dict[str, np.ndarray], index: IVFIndex,
                    nq: int = BATCH, nprobe: int = NPROBE,
                    k: int = K) -> np.ndarray:
    """Exact-IVF oracle ids [nq, k]: full-precision L2 over the probed
    lists, the recall ceiling of probing alone (no PQ, bf16 or
    COARSE_PROBE loss)."""
    base = data["base"]
    centroids = _host(index.centroids)
    list_ids = _host(index.list_ids)
    list_sizes = _host(index.list_sizes)
    queries = data["query"][:nq].astype(np.float32)
    out = np.empty((len(queries), k), np.int64)
    for qi, q in enumerate(queries):
        d2c = ((centroids - q) ** 2).sum(-1)
        probes = np.argsort(d2c)[:nprobe]
        cand = np.concatenate(
            [list_ids[p, : list_sizes[p]] for p in probes]
        )
        d2 = ((base[cand] - q) ** 2).sum(-1)
        out[qi] = cand[np.argsort(d2, kind="stable")[:k]]
    return out
