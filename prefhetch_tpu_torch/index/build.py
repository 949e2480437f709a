"""IVF(-PQ) index training, building and npz save/load — the port of
prefhetch_tpu/index/build.py.

- coarse quantizer: k-means on the device (ops/kmeans.py),
- PQ codebooks: per-subspace k-means on residuals, all M subspaces batched,
- ``add``: chunked assignment matmul on the device + host-side bucketing into
  the dense padded inverted-list layout (index/types.py), exactly as the JAX
  package buckets,
- save/load: the JAX package's npz format under the same parameter-encoding
  filename, so either package reads the other's file. ``index_from_numpy``
  turns the JAX package's index fields, as numpy arrays, into the port's
  ``IVFIndex``; ``load_index`` reads the npz through it.

The SQ8 quantizer (``quantizer="sq8"``) trains its per-dimension min and
scale on the train set in numpy, exactly as the JAX package does, so the
codes are bit-equal given the same lists.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.index.types import IVFIndex, pad_to_lane
from prefhetch_tpu_torch.ops.kmeans import train_kmeans, train_kmeans_batched
from prefhetch_tpu_torch.ops.topk import topk_smallest
from prefhetch_tpu_torch.utils.config import IndexParams


def _coarse_d2_chunks(x: np.ndarray, centroids: np.ndarray, chunk: int,
                      dev: torch.device):
    """Yield (start, ‖c‖² − 2·x·cᵀ [c, nlist]) over chunks of x."""
    c = torch.tensor(centroids, dtype=torch.float32, device=dev)
    csq = torch.sum(c * c, dim=-1)
    for s in range(0, x.shape[0], chunk):
        xs = torch.tensor(x[s : s + chunk], dtype=torch.float32, device=dev)
        yield s, csq[None, :] - 2.0 * (xs @ c.T)


def assign_to_lists(
    x: np.ndarray, centroids: np.ndarray, chunk: int = 65536,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Coarse-quantizer assignment of all vectors → list id [n] int32."""
    dev = resolve_device(device)
    out = np.empty(x.shape[0], np.int32)
    for s, d2 in _coarse_d2_chunks(x, centroids, chunk, dev):
        out[s : s + d2.shape[0]] = torch.argmin(d2, dim=-1).cpu().numpy()
    return out


def assign_to_lists_balanced(
    x: np.ndarray,
    centroids: np.ndarray,
    cap_factor: float = 1.25,
    n_cand: int = 4,
    chunk: int = 65536,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Capacity-bounded coarse assignment: list sizes ≤ cap_factor·(n/nlist).

    The n_cand nearest centroids per point come from the device; the greedy
    claiming rounds run on the host exactly as in the JAX package
    (index/build.py:67-123)."""
    dev = resolve_device(device)
    n = x.shape[0]
    nlist = centroids.shape[0]
    cap = int(np.ceil(cap_factor * n / nlist))
    top_d = np.empty((n, n_cand), np.float32)
    top_i = np.empty((n, n_cand), np.int32)
    for s, d2 in _coarse_d2_chunks(x, centroids, chunk, dev):
        dd, ii = topk_smallest(d2, n_cand)
        top_d[s : s + d2.shape[0]] = dd.cpu().numpy()
        top_i[s : s + d2.shape[0]] = ii.cpu().numpy()

    assign = np.full(n, -1, np.int64)
    remaining = np.full(nlist, cap, np.int64)
    pending = np.arange(n)
    for r in range(n_cand):
        if pending.size == 0:
            break
        lists_r = top_i[pending, r].astype(np.int64)
        d_r = top_d[pending, r]
        order = np.lexsort((d_r, lists_r))
        sl = lists_r[order]
        # rank of each claimant within its list group (groups contiguous)
        starts = np.searchsorted(sl, np.arange(nlist))
        rank = np.arange(order.size) - starts[sl]
        accept = rank < remaining[sl]
        chosen = order[accept]
        assign[pending[chosen]] = sl[accept]
        remaining -= np.bincount(sl[accept], minlength=nlist)
        pending = pending[order[~accept]]
    if pending.size:
        # exhausted all candidates: fill least-loaded lists
        fill_order = np.argsort(-remaining, kind="stable")
        slots = np.repeat(fill_order, np.maximum(remaining[fill_order], 0))
        assign[pending] = slots[: pending.size]
    return assign.astype(np.int32)


def train_pq_codebooks(
    train: np.ndarray,            # [nt, d] training vectors
    centroids: np.ndarray,        # [nlist, d] trained coarse quantizer
    params: IndexParams,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Train PQ codebooks [M, ksub, dsub] on residuals x − centroid(x)
    (FAISS IndexIVFPQ by_residual default), one k-means per subspace."""
    M, dsub, ksub = params.pq_m, params.dsub, params.ksub
    xt = np.asarray(train, np.float32)
    if params.by_residual:
        assign = assign_to_lists(xt, centroids, device=device)
        xt = xt - centroids[assign]
    sub = xt.reshape(xt.shape[0], M, dsub).transpose(1, 0, 2)  # [M, nt, dsub]
    return train_kmeans_batched(
        sub, k=ksub, iters=params.pq_kmeans_iters, seed=params.seed,
        device=device,
    ).astype(np.float32)


def encode_pq(
    x: np.ndarray,
    assign: np.ndarray,
    centroids: np.ndarray,
    codebooks: np.ndarray,
    params: IndexParams,
    chunk: int = 65536,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """PQ-encode all vectors → codes [n, M] uint8 (argmin codeword per
    subspace of the residual)."""
    dev = resolve_device(device)
    n = x.shape[0]
    M = params.pq_m
    codes = np.empty((n, M), np.uint8)
    cb = torch.tensor(codebooks, dtype=torch.float32, device=dev)
    cbsq = torch.sum(cb * cb, dim=-1)                       # [M, ksub]
    for s in range(0, n, chunk):
        xs = np.asarray(x[s : s + chunk], np.float32)
        if params.by_residual:
            xs = xs - centroids[assign[s : s + chunk]]
        res = torch.tensor(xs.reshape(xs.shape[0], M, params.dsub),
                           device=dev)
        cross = torch.einsum("cmd,mkd->cmk", res, cb)
        a = torch.argmin(cbsq[None] - 2.0 * cross, dim=-1)
        codes[s : s + chunk] = a.to(torch.uint8).cpu().numpy()
    return codes


def sq8_encode(
    train: np.ndarray, base: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The index's per-dimension 8-bit scalar quantizer (faiss
    IndexIVFScalarQuantizer QT_8bit analog): min and scale trained on the
    train set, ``base`` rounded to uint8 codes → (codes [n, d] uint8, vmin
    [d] f32, scale [d] f32); x ≈ vmin + (code + ½)·scale."""
    train_f = np.asarray(train, np.float32)
    vmin = train_f.min(axis=0)
    vmax = train_f.max(axis=0)
    scale = np.maximum((vmax - vmin) / 255.0, 1e-12).astype(np.float32)
    codes8 = np.clip(
        np.round((base - vmin) / scale), 0, 255
    ).astype(np.uint8)
    return codes8, vmin, scale


def build_ivf_index(
    train: np.ndarray,
    base: np.ndarray,
    params: IndexParams,
    device: "str | torch.device" = "cuda",
) -> IVFIndex:
    """Full index build: train the coarse quantizer (+PQ), add all base
    vectors (reference: src/server/server_lib.cpp:55-84)."""
    dev = resolve_device(device)
    base = np.asarray(base, np.float32)
    if base.shape[1] != params.d:
        raise ValueError(
            "dataset does not have same dimension as configured d"
        )
    if params.metric == "cosine":
        from prefhetch_tpu_torch.data.synthetic import normalize_rows

        base = normalize_rows(base)
        train = normalize_rows(train)
    centroids = train_kmeans(
        np.asarray(train, np.float32),
        k=params.nlist,
        iters=params.kmeans_iters,
        seed=params.seed,
        spherical=(params.metric == "cosine"),
        device=dev,
    )
    if params.balance > 0:
        assign = assign_to_lists_balanced(
            base, centroids, cap_factor=params.balance, device=dev
        )
    else:
        assign = assign_to_lists(base, centroids, device=dev)

    codebooks = codes = None
    if params.uses_pq:
        codebooks = train_pq_codebooks(train, centroids, params, device=dev)
        codes = encode_pq(base, assign, centroids, codebooks, params,
                          device=dev)

    # Bucket into dense padded lists (host side, one pass).
    nlist = params.nlist
    order = np.argsort(assign, kind="stable")     # stable: preserves add order
    sorted_assign = assign[order]
    sizes = np.bincount(assign, minlength=nlist).astype(np.int32)
    lmax = pad_to_lane(int(sizes.max()) if sizes.size else 1)
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])

    list_ids = np.full((nlist, lmax), -1, np.int32)
    rank_in_list = np.arange(base.shape[0]) - offsets[sorted_assign]
    list_ids[sorted_assign, rank_in_list] = order.astype(np.int32)

    arrays: Dict[str, np.ndarray] = {
        "centroids": centroids, "list_ids": list_ids, "list_sizes": sizes,
    }
    if params.uses_sq8:
        codes8, vmin, scale = sq8_encode(train, base)
        list_sq = np.zeros((nlist, lmax, params.d), np.uint8)
        list_sq[sorted_assign, rank_in_list] = codes8[order]
        arrays["list_sq"] = list_sq
        arrays["sq_vmin"] = vmin
        arrays["sq_scale"] = scale
    elif params.uses_pq:
        list_codes = np.zeros((nlist, lmax, params.pq_m), np.uint8)
        list_codes[sorted_assign, rank_in_list] = codes[order]
        arrays["list_codes"] = list_codes
        arrays["codebooks"] = codebooks
        # dense scan payload: z = centroid + decode(code) per stored vector
        # (the ADC distance ‖r − decode(code)‖² equals ‖q − z‖²), bf16
        decoded = codebooks[
            np.arange(params.pq_m)[None, :], codes
        ].reshape(base.shape[0], params.d)                  # [n, d]
        recon = decoded + (centroids[assign] if params.by_residual else 0.0)
        list_recon = np.zeros((nlist, lmax, params.d), np.float32)
        list_recon[sorted_assign, rank_in_list] = recon[order]
        # round-to-nearest-even, as ml_dtypes rounds in the JAX package
        recon_bf16 = torch.from_numpy(list_recon).to(torch.bfloat16)
        arrays["list_recon_bf16"] = recon_bf16.view(torch.int16).numpy()
        # norms of the bf16-rounded payload (what the scan actually sees),
        # summed by numpy as the JAX package sums them
        arrays["list_norms"] = (
            recon_bf16.to(torch.float32).numpy() ** 2
        ).sum(-1).astype(np.float32)
    else:
        list_vectors = np.zeros((nlist, lmax, params.d), np.float32)
        list_vectors[sorted_assign, rank_in_list] = base[order]
        arrays["list_vectors"] = list_vectors
        arrays["list_norms"] = (
            (list_vectors.astype(np.float64) ** 2).sum(-1)
        ).astype(np.float32)
    return index_from_numpy(arrays, params, dev)


def index_from_numpy(
    arrays: Dict[str, np.ndarray],
    params: IndexParams,
    device: "str | torch.device" = "cuda",
) -> IVFIndex:
    """The JAX package's index fields, as numpy arrays, → the port's index.

    Keys are the npz field names of ``save_index`` (``centroids``,
    ``list_ids``, ``list_sizes``, ``list_norms``, ``list_codes``,
    ``codebooks``, ``list_recon_bf16``, ``list_vectors``, ``list_sq``,
    ``sq_vmin``, ``sq_scale``). The bf16 payload
    may come as its raw 16-bit pattern (npz) or as an ml_dtypes bfloat16
    array (``np.asarray`` of a JAX field, key ``list_recon``); PQ codes as
    uint8 (npz) or int32 (the JAX device layout)."""
    dev = resolve_device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)

    ids = np.asarray(arrays["list_ids"], np.int32)
    sizes = np.asarray(arrays["list_sizes"], np.int32)
    host = {"ids": ids, "sizes": sizes}
    kw = {}
    if arrays.get("list_norms") is not None:
        host["norms"] = np.asarray(arrays["list_norms"], np.float32)
        kw["list_norms"] = t(host["norms"])
    if arrays.get("list_sq") is not None:
        kw["list_sq"] = t(np.asarray(arrays["list_sq"], np.uint8))
        kw["sq_vmin"] = t(np.asarray(arrays["sq_vmin"], np.float32))
        kw["sq_scale"] = t(np.asarray(arrays["sq_scale"], np.float32))
    elif arrays.get("list_codes") is not None:
        host["codes"] = np.asarray(arrays["list_codes"]).astype(
            np.uint8, copy=False
        )
        kw["list_codes"] = t(host["codes"])
        kw["codebooks"] = t(np.asarray(arrays["codebooks"], np.float32))
        recon = arrays.get("list_recon_bf16")
        if recon is None:
            recon = arrays.get("list_recon")
        if recon is not None:
            if recon.dtype.itemsize != 2:
                raise ValueError("list_recon must hold bfloat16 bits")
            bits = np.asarray(recon).view(np.int16)
            kw["list_recon"] = t(bits).view(torch.bfloat16)
            host["payload"] = bits
    elif arrays.get("list_vectors") is not None:
        vecs = np.asarray(arrays["list_vectors"], np.float32)
        kw["list_vectors"] = t(vecs)
        host["payload"] = vecs
    return IVFIndex(
        centroids=t(np.asarray(arrays["centroids"], np.float32)),
        list_ids=t(ids),
        list_sizes=t(sizes),
        params=params,
        ntotal_host=int(sizes.sum()),
        host_arrays=host,
        **kw,
    )


def save_index(index: IVFIndex, directory: str) -> str:
    """Serialize to the JAX package's npz format under the parameter-encoding
    filename (reference: src/server/server_lib.cpp:38-42,82)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, index.params.artifact_name())
    arrays = {
        "centroids": index.centroids.cpu().numpy(),
        "list_ids": index.list_ids.cpu().numpy(),
        "list_sizes": index.list_sizes.cpu().numpy(),
    }
    if index.list_norms is not None:
        arrays["list_norms"] = index.list_norms.cpu().numpy()
    if index.list_sq is not None:
        arrays["list_sq"] = index.list_sq.cpu().numpy()
        arrays["sq_vmin"] = index.sq_vmin.cpu().numpy()
        arrays["sq_scale"] = index.sq_scale.cpu().numpy()
    elif index.uses_pq:
        arrays["list_codes"] = index.list_codes.cpu().numpy().astype(np.uint8)
        arrays["codebooks"] = index.codebooks.cpu().numpy()
        if index.list_recon is not None:
            # bf16 stored as raw uint16 bit pattern (npz has no bf16 dtype)
            arrays["list_recon_bf16"] = (
                index.list_recon.cpu().view(torch.int16).numpy()
                .view(np.uint16)
            )
    else:
        arrays["list_vectors"] = index.list_vectors.cpu().numpy()
    arrays["params_json"] = np.frombuffer(
        json.dumps(dataclasses.asdict(index.params)).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)
    return path


def load_index(path: str, device: "str | torch.device" = "cuda") -> IVFIndex:
    """Read an index saved by either package's save_index."""
    with np.load(path) as z:
        params = IndexParams(**json.loads(bytes(z["params_json"]).decode()))
        arrays = {k: z[k] for k in z.files if k != "params_json"}
    return index_from_numpy(arrays, params, device)
