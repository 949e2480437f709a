"""K5 and K4: per (query, probed tile) slab distances.

Ports of the TPU kernels prefhetch_tpu/ops/pallas_scan.py
``pallas_slab_distances`` (:161-213, body ``_kernel`` :29-58) — K5 — and
``pallas_slab_distances_sq8`` (:100-158, body ``_kernel_sq8`` :61-97) — K4.
For every query qi and probe slot k, with tile = probe_ids[qi, k]:

    out[qi, k·T + t] = max(‖q‖² + norms[tile, t] − 2·cross[t], 0)  t <  size
    out[qi, k·T + t] = PAD                                         t >= size

    K5: cross[t] = ⟨payload[tile, t], q⟩       (bf16/f32 payload widened to f32)
    K4: cross[t] = ⟨code[tile, t] + ½, scale⊙q⟩ + ⟨vmin, q⟩    (uint8 codes)

The query stays f32 (K1 casts it to a bf16 payload's type; these two do
not), and K4 keeps the folded affine form instead of decode-then-dot. A
size-0 tile yields PAD.

K5 runs one block per pair. K4 is tile-major: ``sq8_schedule`` sorts the
flat pairs by tile id on the device (a stable ``torch.sort``, no host sync)
and the kernel takes ``SQ8_CHUNK`` consecutive sorted pairs a block, so the
pairs of a chunk that share a tile read and decode it once. ``sq8_runs``
lists the (chunk, run of one tile) pieces that the kernel's blocks walk, in
plain torch, for the tests and for counting tile reads.

``slab_distances`` and ``slab_distances_sq8`` pick by the device of their
tensors: CPU tensors take the plain PyTorch versions
(``slab_distances_plain``, ``slab_distances_sq8_plain``), CUDA tensors launch
the hand-written kernels of ``csrc/slab_scan.cu`` (nvcc for sm_90a, bound
with ctypes, built at first use) or raise. There is no fallback from a
kernel to its plain version. ``.launches`` on each wrapper counts kernel
launches and ``.calls`` on each plain version counts its calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE

_LIB = "slab_scan"
_PLAIN_CHUNK_BYTES = 256 << 20      # widened f32 slab per chunk of pairs
_MAX_SMEM = 232448                  # bytes a block may opt into on sm_90
SQ8_CHUNK = 4                       # sorted pairs a K4 block (csrc CHUNK)


def _plain(payload, norms, sizes, queries, probe_ids,
           vmin: Optional[torch.Tensor], scale: Optional[torch.Tensor]):
    """Both plain versions: gather the probed slabs (a chunk of pairs at a
    time), one batched f32 matvec, norms, clamp, mask."""
    nq, max_t = probe_ids.shape
    _, T, d = payload.shape
    q = queries.to(torch.float32)
    qsq = torch.sum(q * q, dim=-1)                            # [nq]
    flat = probe_ids.reshape(-1).long()                       # [B]
    qrep = torch.repeat_interleave(q, max_t, dim=0)           # [B, d]
    if vmin is not None:
        bias = torch.repeat_interleave(
            torch.sum(vmin * q, dim=-1), max_t)               # [B]
        qrep = qrep * scale
    B = flat.shape[0]
    chunk = max(1, _PLAIN_CHUNK_BYTES // (T * d * 4))
    cross = torch.empty((B, T), dtype=torch.float32, device=payload.device)
    for s in range(0, B, chunk):
        slab = payload[flat[s:s + chunk]].to(torch.float32)   # [c, T, d]
        if vmin is not None:
            slab = slab + 0.5
        cross[s:s + chunk] = torch.bmm(
            slab, qrep[s:s + chunk, :, None])[..., 0]
    if vmin is not None:
        cross = cross + bias[:, None]
    d2 = torch.repeat_interleave(qsq, max_t)[:, None] + norms[flat] \
        - 2.0 * cross
    d2 = torch.clamp(d2, min=0.0)
    lane = torch.arange(T, device=payload.device)
    valid = lane[None, :] < sizes[flat][:, None]              # [B, T]
    return torch.where(valid, d2, PAD_DISTANCE).reshape(nq, max_t * T)


def slab_distances_plain(
    payload: torch.Tensor,    # [ntiles+1, T, d] bf16/f32
    norms: torch.Tensor,      # [ntiles+1, T] f32
    sizes: torch.Tensor,      # [ntiles+1] int32
    queries: torch.Tensor,    # [nq, d] f32
    probe_ids: torch.Tensor,  # [nq, max_t] int32
) -> torch.Tensor:
    """Plain PyTorch version of K5: distances [nq, max_t·T] f32."""
    slab_distances_plain.calls += 1
    return _plain(payload, norms, sizes, queries, probe_ids, None, None)


slab_distances_plain.calls = 0


def slab_distances_sq8_plain(
    payload: torch.Tensor,    # [ntiles+1, T, d] uint8 SQ8 codes
    norms: torch.Tensor,      # [ntiles+1, T] f32 (decoded-value norms)
    sizes: torch.Tensor,      # [ntiles+1] int32
    vmin: torch.Tensor,       # [d] f32
    scale: torch.Tensor,      # [d] f32
    queries: torch.Tensor,    # [nq, d] f32
    probe_ids: torch.Tensor,  # [nq, max_t] int32
) -> torch.Tensor:
    """Plain PyTorch version of K4: distances [nq, max_t·T] f32."""
    slab_distances_sq8_plain.calls += 1
    return _plain(payload, norms, sizes, queries, probe_ids,
                  vmin.to(torch.float32), scale.to(torch.float32))


slab_distances_sq8_plain.calls = 0


def sq8_schedule(probe_ids: torch.Tensor, n_tiles: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's schedule: the flat pairs (query qi, slot k) → qi·max_t + k of
    ``probe_ids`` [nq, max_t] (tile ids below ``n_tiles``) sorted by tile
    id, stably, on ``probe_ids``' device. Returns (tiles [P] sorted, order
    [P] int64: the flat pair of each). The keys are int16 when every tile id
    fits (a radix sort over half the bits), else int32."""
    flat = probe_ids.reshape(-1)
    if n_tiles <= torch.iinfo(torch.int16).max + 1:
        flat = flat.to(torch.int16)
    return torch.sort(flat, stable=True)


def sq8_runs(tiles: torch.Tensor, chunk: int = SQ8_CHUNK
             ) -> Tuple[torch.Tensor, ...]:
    """The pieces K4's blocks walk: block b takes sorted pairs
    [b·chunk, (b+1)·chunk) and splits them into runs of one tile. Returns
    (block, start, length, tile) per run, int64, in the kernel's order; a
    run of a tile with rows is one read of that tile."""
    n = tiles.numel()
    pos = torch.arange(n, device=tiles.device)
    first = pos % chunk == 0
    first[1:] |= tiles[1:] != tiles[:-1]
    start = pos[first]
    length = torch.diff(start, append=torch.tensor([n], device=tiles.device))
    return start // chunk, start, length, tiles[start].long()


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfh_slab_distances.restype = i
    lib.pfh_slab_distances.argtypes = [
        p, i,                      # payload, is_bf16
        p, p, p, p,                # norms, sizes, queries, probe_ids
        i, i, i, i,                # nq, max_t, T, d
        p, p,                      # out, stream
    ]
    lib.pfh_slab_distances_sq8.restype = i
    lib.pfh_slab_distances_sq8.argtypes = [
        p, p, p, p, p, p,          # codes, norms, sizes, vmin, scale, q
        p, p,                      # probe_ids, the flat pairs by tile
        i, i, i, i,                # nq, max_t, T, d
        p, p,                      # out, stream
    ]
    return lib


def _check(payload, norms, sizes, queries, probe_ids, dtypes, d_mult,
           affine=(), smem=None) -> None:
    dev = payload.device
    for name, t in (("norms", norms), ("sizes", sizes), ("queries", queries),
                    ("probe_ids", probe_ids), *affine):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, payload on {dev}")
    if payload.dtype not in dtypes:
        raise ValueError(f"payload must be one of {dtypes}, got "
                         f"{payload.dtype}")
    if payload.dim() != 3 or not payload.is_contiguous():
        raise ValueError("payload must be a contiguous [ntiles+1, T, d]")
    ntp1, T, d = payload.shape
    if d % d_mult != 0:
        raise ValueError(f"the kernel takes d divisible by {d_mult} for "
                         f"{payload.dtype}, got d={d}")
    if payload.data_ptr() % 16 != 0:
        raise ValueError("payload must be 16-byte aligned")
    if norms.dtype != torch.float32 or tuple(norms.shape) != (ntp1, T) \
            or not norms.is_contiguous():
        raise ValueError("norms must be a contiguous f32 [ntiles+1, T]")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (ntp1,) \
            or not sizes.is_contiguous():
        raise ValueError("sizes must be a contiguous int32 [ntiles+1]")
    if probe_ids.dtype != torch.int32 or probe_ids.dim() != 2 \
            or not probe_ids.is_contiguous() or probe_ids.numel() == 0:
        raise ValueError("probe_ids must be a non-empty contiguous int32 "
                         "[nq, max_t]")
    if queries.dim() != 2 or tuple(queries.shape) != (probe_ids.shape[0], d):
        raise ValueError(f"queries must be [{probe_ids.shape[0]}, {d}]")
    for name, t in affine:
        if t.dtype != torch.float32 or tuple(t.shape) != (d,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [{d}]")
    need = 4 * (d + 8 + T) if smem is None else smem(T, d)
    if need > _MAX_SMEM:
        raise ValueError(f"T={T}, d={d} needs more shared memory than a "
                         f"block may use ({_MAX_SMEM} bytes)")


def sq8_smem_bytes(T: int, d: int) -> int:
    """K4's shared memory: each of the 8 warps' ring of 4 stages of 8 code
    rows with their norms; each pair of a chunk's scale⊙q [d], ‖q‖²,
    ⟨vmin, q⟩ and three ints. T does not enter: the lanes finish their own
    rows."""
    return 8 * 4 * 8 * (d + 4) + 4 * SQ8_CHUNK * (d + 2) + 12 * SQ8_CHUNK


def slab_distances(
    payload: torch.Tensor,    # [ntiles+1, T, d] bf16/f32
    norms: torch.Tensor,      # [ntiles+1, T] f32
    sizes: torch.Tensor,      # [ntiles+1] int32
    queries: torch.Tensor,    # [nq, d] f32
    probe_ids: torch.Tensor,  # [nq, max_t] int32 tile ids, each < ntiles+1
) -> torch.Tensor:
    """K5 on the tensors' device: distances [nq, max_t·T] f32, PAD at
    invalid lanes."""
    if payload.device.type == "cpu":
        return slab_distances_plain(payload, norms, sizes, queries, probe_ids)
    if payload.device.type != "cuda":
        raise ValueError(f"K5 runs on cuda or cpu, not {payload.device}")
    _check(payload, norms, sizes, queries, probe_ids,
           (torch.bfloat16, torch.float32), 8)
    lib = _library()
    _, T, d = payload.shape
    nq, max_t = probe_ids.shape
    with torch.cuda.device(payload.device):
        q = queries.to(torch.float32).contiguous()
        out = torch.empty((nq, max_t * T), dtype=torch.float32,
                          device=payload.device)
        err = lib.pfh_slab_distances(
            payload.data_ptr(), int(payload.dtype == torch.bfloat16),
            norms.data_ptr(), sizes.data_ptr(), q.data_ptr(),
            probe_ids.data_ptr(), nq, max_t, T, d, out.data_ptr(),
            torch.cuda.current_stream(payload.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"slab_distances kernel launch failed: "
                           f"cudaError {err}")
    slab_distances.launches += 1
    return out


slab_distances.launches = 0


def slab_distances_sq8(
    payload: torch.Tensor,    # [ntiles+1, T, d] uint8 SQ8 codes
    norms: torch.Tensor,      # [ntiles+1, T] f32 (decoded-value norms)
    sizes: torch.Tensor,      # [ntiles+1] int32
    vmin: torch.Tensor,       # [d] f32
    scale: torch.Tensor,      # [d] f32
    queries: torch.Tensor,    # [nq, d] f32
    probe_ids: torch.Tensor,  # [nq, max_t] int32 tile ids, each < ntiles+1
) -> torch.Tensor:
    """K4 on the tensors' device: SQ8 distances [nq, max_t·T] f32, PAD at
    invalid lanes."""
    if payload.device.type == "cpu":
        return slab_distances_sq8_plain(payload, norms, sizes, vmin, scale,
                                        queries, probe_ids)
    if payload.device.type != "cuda":
        raise ValueError(f"K4 runs on cuda or cpu, not {payload.device}")
    _check(payload, norms, sizes, queries, probe_ids, (torch.uint8,), 16,
           affine=(("vmin", vmin), ("scale", scale)), smem=sq8_smem_bytes)
    lib = _library()
    _, T, d = payload.shape
    nq, max_t = probe_ids.shape
    with torch.cuda.device(payload.device):
        q = queries.to(torch.float32).contiguous()
        _, order = sq8_schedule(probe_ids, payload.shape[0])
        out = torch.empty((nq, max_t * T), dtype=torch.float32,
                          device=payload.device)
        err = lib.pfh_slab_distances_sq8(
            payload.data_ptr(), norms.data_ptr(), sizes.data_ptr(),
            vmin.data_ptr(), scale.data_ptr(), q.data_ptr(),
            probe_ids.data_ptr(), order.data_ptr(), nq, max_t, T, d,
            out.data_ptr(),
            torch.cuda.current_stream(payload.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"slab_distances_sq8 kernel launch failed: "
                           f"cudaError {err}")
    slab_distances_sq8.launches += 1
    return out


slab_distances_sq8.launches = 0
