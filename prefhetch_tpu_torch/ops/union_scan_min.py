"""K1: the union-tile scan with a fused per-tile minimum.

Port of the TPU kernel prefhetch_tpu/ops/pallas_scan.py
``pallas_union_scan_min`` (:256-327, kernel body ``_kernel_union_min``
:216-253). Over the union tiles:

    d2[u, q, t] = max(‖q‖² + ‖x_t‖² − 2·q·x_t, 0), PAD at t ≥ sizes[tile]
    dmin[u, 0, q] = min_t d2[u, q, t]       (f32, before the bf16 cast)

returned as (d2 bf16 [U, nq, T] query-major, PAD → +inf; dmin f32
[U, 1, nq]). The queries are cast to a bf16 payload's type before the
product; ‖q‖² comes from the f32 queries.

``union_scan_min`` picks by the device of its tensors: CPU tensors take the
plain PyTorch version (``union_scan_min_reference``), CUDA tensors launch
the hand-written kernel ``csrc/union_scan_min.cu`` (nvcc for sm_90a, bound
with ctypes, built at first use) or raise. A bf16 payload goes to the
tensor cores (mma.sync bf16, f32 accumulation, payload chunks streamed
through a cp.async ring); an f32 payload to an FMA loop on the FP32 cores.
There is no fallback from the kernel to the plain version.
``union_scan_min.launches`` counts kernel launches and
``union_scan_min_reference.calls`` counts plain-version calls, so a run can
show which one it went through.
"""

from __future__ import annotations

import ctypes

import torch

from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE

_LIB = "union_scan_min"
_MAX_SMEM = 232448                  # bytes a block may opt into on sm_90

# Union tiles one product of union_distances takes. The union is padded to a
# multiple of it, so every product has the one shape [SCAN_CHUNK·T, d] ×
# [d, nq] whatever the union's length: a library GEMM may sum in another
# order at another shape, and a tile's distances must not depend on which
# union, or which shard's share of one (parallel/sharded.py), it came in.
SCAN_CHUNK = 128


def _queries_for(payload: torch.Tensor, queries: torch.Tensor):
    """(‖q‖² f32 [nq] of the f32 queries, queries in the product's type)."""
    q = queries.to(torch.float32)
    qsq = torch.sum(q * q, dim=-1)
    qc = q.to(payload.dtype) if payload.dtype == torch.bfloat16 else q
    return qsq, qc


def union_distances(
    payload: torch.Tensor,   # [ntiles+1, T, d] bf16/f32
    norms: torch.Tensor,     # [ntiles+1, T] f32
    sizes: torch.Tensor,     # [ntiles+1] int32
    queries: torch.Tensor,   # [nq, d] f32
    union: torch.Tensor,     # [U] int32 tile ids
) -> torch.Tensor:
    """K1's distances in f32, tile-major [U, T, nq], PAD at t ≥ size: the
    plain formula that the kernel's plain version and the unfused f32 scans
    of ops/union_scan.py share. The product runs SCAN_CHUNK tiles at a
    time, the last chunk padded with the union's last tile."""
    T = payload.shape[1]
    U = union.shape[0]
    u = union.long()
    qsq, qc = _queries_for(payload, queries)
    qt = qc.to(torch.float32).T
    up = torch.cat([u, u[-1:].expand(-U % SCAN_CHUNK)])
    # bf16 x bf16 products are exact in f32; the sum runs in f32
    cross = torch.cat([
        torch.matmul(payload[up[i:i + SCAN_CHUNK]].to(torch.float32), qt)
        for i in range(0, up.shape[0], SCAN_CHUNK)
    ])[:U]                                                  # [U, T, nq]
    d2 = qsq[None, None, :] + norms[u][:, :, None] - 2.0 * cross
    d2 = torch.clamp(d2, min=0.0)
    lane = torch.arange(T, device=payload.device)
    valid = lane[None, :] < sizes[u][:, None]               # [U, T]
    return torch.where(valid[:, :, None], d2, PAD_DISTANCE)


def union_scan_min_reference(
    payload: torch.Tensor,   # [ntiles+1, T, d] bf16/f32
    norms: torch.Tensor,     # [ntiles+1, T] f32
    sizes: torch.Tensor,     # [ntiles+1] int32
    queries: torch.Tensor,   # [nq, d] f32
    union: torch.Tensor,     # [U] int32 tile ids
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: gather, f32 product, mask, min, cast."""
    union_scan_min_reference.calls += 1
    d2 = union_distances(payload, norms, sizes, queries, union)
    d2 = d2.transpose(1, 2)                                 # [U, nq, T]
    dmin = torch.amin(d2, dim=2)[:, None, :]                # [U, 1, nq]
    return d2.to(torch.bfloat16).contiguous(), dmin


union_scan_min_reference.calls = 0


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    lib.pfh_union_scan_min_bf16_smem.restype = ctypes.c_int
    lib.pfh_union_scan_min_bf16_smem.argtypes = [ctypes.c_int]
    fn = lib.pfh_union_scan_min
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,                 # payload, is_bf16
        ctypes.c_void_p, ctypes.c_void_p,              # norms, sizes
        ctypes.c_void_p, ctypes.c_void_p,              # queries, qsq
        ctypes.c_void_p,                               # union
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # U nq T d
        ctypes.c_void_p, ctypes.c_void_p,              # d2, dmin
        ctypes.c_void_p,                               # stream
    ]
    return lib


def _check(payload, norms, sizes, queries, union) -> None:
    dev = payload.device
    for name, t in (("norms", norms), ("sizes", sizes),
                    ("queries", queries), ("union", union)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, payload on {dev}")
    if payload.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"payload must be bf16 or f32, got {payload.dtype}")
    if payload.dim() != 3 or not payload.is_contiguous():
        raise ValueError("payload must be a contiguous [ntiles+1, T, d]")
    ntp1, T, d = payload.shape
    if d % 8 != 0:
        raise ValueError(f"K1 takes d divisible by 8, got d={d}")
    if payload.data_ptr() % 16 != 0:
        raise ValueError("payload must be 16-byte aligned")
    if norms.dtype != torch.float32 or tuple(norms.shape) != (ntp1, T) \
            or not norms.is_contiguous():
        raise ValueError("norms must be a contiguous f32 [ntiles+1, T]")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (ntp1,) \
            or not sizes.is_contiguous():
        raise ValueError("sizes must be a contiguous int32 [ntiles+1]")
    if union.dtype != torch.int32 or union.dim() != 1 \
            or not union.is_contiguous() or union.shape[0] == 0:
        raise ValueError("union must be a non-empty contiguous int32 [U]")
    if queries.dim() != 2 or queries.shape[1] != d or queries.shape[0] == 0:
        raise ValueError(f"queries must be [nq, {d}] with nq > 0")


def union_scan_min(
    payload: torch.Tensor,   # [ntiles+1, T, d] bf16/f32
    norms: torch.Tensor,     # [ntiles+1, T] f32
    sizes: torch.Tensor,     # [ntiles+1] int32
    queries: torch.Tensor,   # [nq, d] f32
    union: torch.Tensor,     # [U] int32 tile ids, each < ntiles+1
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on the tensors' device: (d2 bf16 [U, nq, T], dmin f32 [U, 1, nq])."""
    if payload.device.type == "cpu":
        return union_scan_min_reference(payload, norms, sizes, queries, union)
    if payload.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu, not {payload.device}")
    _check(payload, norms, sizes, queries, union)
    lib = _library()
    _, T, d = payload.shape
    U, nq = union.shape[0], queries.shape[0]
    bf16 = payload.dtype == torch.bfloat16
    if bf16 and lib.pfh_union_scan_min_bf16_smem(d) > _MAX_SMEM:
        raise ValueError(f"d={d}: the bf16 query block and payload ring "
                         f"exceed the shared memory a block may use")
    with torch.cuda.device(payload.device):
        qsq, qc = _queries_for(payload, queries)
        qc = qc.contiguous()
        d2 = torch.empty((U, nq, T), dtype=torch.bfloat16,
                         device=payload.device)
        dmin = torch.empty((U, 1, nq), dtype=torch.float32,
                           device=payload.device)
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        err = lib.pfh_union_scan_min(
            payload.data_ptr(), int(bf16),
            norms.data_ptr(), sizes.data_ptr(), qc.data_ptr(),
            qsq.data_ptr(), union.data_ptr(), U, nq, T, d,
            d2.data_ptr(), dmin.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"union_scan_min kernel launch failed: "
                           f"cudaError {err}")
    union_scan_min.launches += 1
    return d2, dmin


union_scan_min.launches = 0
