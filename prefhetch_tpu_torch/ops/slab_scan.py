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

Both are tile-major. ``tile_schedule`` sorts a batch's flat (query, slot)
pairs by tile id on the device (``csrc/tile_schedule.cu``: one launch of a
stable counting sort, bit-equal to ``torch.sort(stable=True)``, no host
sync), so the pairs that probe one tile share one read of it. K4 takes
``SQ8_CHUNK`` consecutive sorted pairs a block; K5 takes a piece of at most
``SLAB_CHUNK`` pairs of one tile, from the piece list the same launch
writes. ``tile_runs`` lists the (block, run of one tile) pieces that either
kernel's blocks walk, in plain torch, for the tests and for counting tile
reads.

``slab_distances``, ``slab_distances_sq8`` and ``tile_schedule`` pick by the
device of their tensors: CPU tensors take the plain PyTorch versions
(``slab_distances_plain``, ``slab_distances_sq8_plain``,
``tile_schedule_plain``), CUDA tensors launch the hand-written kernels of
``csrc/slab_scan.cu`` and ``csrc/tile_schedule.cu`` (nvcc for sm_90a, bound
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
_SCHEDULE_LIB = "tile_schedule"
_PLAIN_CHUNK_BYTES = 256 << 20      # widened f32 slab per chunk of pairs
_MAX_SMEM = 232448                  # bytes a block may opt into on sm_90
SQ8_CHUNK = 4                       # sorted pairs a K4 block (csrc CHUNK)
SLAB_CHUNK = 8                      # pairs a K5 piece at most (SLAB_CHUNK)
SLAB_NST = 2                        # K5's ring stages (SLAB_NST)
SLAB_WARPS = 8                      # K5's warps a block (SLAB_WARPS)


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


def tile_schedule_plain(probe_ids: torch.Tensor, n_tiles: int,
                        chunk: int = 0):
    """Plain version of the schedule: the flat pairs (query qi, slot k) →
    qi·max_t + k of ``probe_ids`` [nq, max_t] (tile ids below ``n_tiles``)
    sorted by tile id, stably. Returns (tiles [P] sorted, order [P] int64:
    the flat pair of each); the keys are int16 when every tile id fits,
    else int32. With ``chunk`` > 0 also the piece list, int32
    [1 + 2·piece_bound]: the count, then (start, length) of each piece, a
    run of one tile cut into pieces of at most ``chunk`` pairs (entries past
    the count are 0)."""
    tile_schedule_plain.calls += 1
    flat = probe_ids.reshape(-1)
    if n_tiles <= torch.iinfo(torch.int16).max + 1:
        flat = flat.to(torch.int16)
    tiles, order = torch.sort(flat, stable=True)
    if chunk <= 0:
        return tiles, order
    _, start, length, _ = tile_runs(tiles, chunk, aligned=True)
    pieces = torch.zeros(1 + 2 * piece_bound(flat.numel(), n_tiles, chunk),
                         dtype=torch.int32, device=flat.device)
    n = start.numel()
    pieces[0] = n
    pieces[1:1 + 2 * n:2] = start.to(torch.int32)
    pieces[2:2 + 2 * n:2] = length.to(torch.int32)
    return tiles, order, pieces


tile_schedule_plain.calls = 0


def piece_bound(P: int, n_tiles: int, chunk: int) -> int:
    """The most pieces of at most ``chunk`` pairs that P pairs over at most
    ``n_tiles`` distinct tiles can make: Σ ⌈c_t / chunk⌉ over the tiles'
    counts c_t, at most (P + R·(chunk − 1)) / chunk with R ≤ min(n_tiles,
    P) tiles, and never more than P. K5's grid is this many blocks."""
    r = min(n_tiles, P)
    return min(P, (P + r * (chunk - 1)) // chunk)


def tile_runs(tiles: torch.Tensor, chunk: int = SQ8_CHUNK,
              aligned: bool = False) -> Tuple[torch.Tensor, ...]:
    """The pieces that the kernels' blocks walk over the sorted ``tiles``.
    Fixed (K4): block b takes sorted pairs [b·chunk, (b+1)·chunk) and splits
    them into runs of one tile. Aligned (K5): each run of one tile is cut
    into pieces of at most ``chunk`` pairs and block b takes piece b.
    Returns (block, start, length, tile) per run, int64, in the kernel's
    order; a run of a tile with rows is one read of that tile."""
    n = tiles.numel()
    pos = torch.arange(n, device=tiles.device)
    new_run = torch.ones(n, dtype=torch.bool, device=tiles.device)
    new_run[1:] = tiles[1:] != tiles[:-1]
    if aligned:
        run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
        first = new_run | ((pos - run_start) % chunk == 0)
    else:
        first = new_run | (pos % chunk == 0)
    start = pos[first]
    length = torch.diff(start, append=torch.tensor([n], device=tiles.device))
    block = (torch.arange(start.numel(), device=tiles.device) if aligned
             else start // chunk)
    return block, start, length, tiles[start].long()


def _schedule_library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_SCHEDULE_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfh_tile_schedule.restype = i
    lib.pfh_tile_schedule.argtypes = [
        p, i, i, i, i,             # keys, P, n_tiles, chunk, int16 keys
        p, p, p, p, p,             # scratch counts, tiles, order, pieces,
    ]                              # stream
    lib.pfh_tile_schedule_scratch.restype = ctypes.c_longlong
    lib.pfh_tile_schedule_scratch.argtypes = [i]
    return lib


def tile_schedule(probe_ids: torch.Tensor, n_tiles: int, chunk: int = 0):
    """The schedule of K4 and K5 on ``probe_ids``' device: (tiles, order)
    sorted by tile, stably, and with ``chunk`` > 0 the piece list, as
    ``tile_schedule_plain`` defines them (piece entries past the count are
    left unwritten on the card). CPU tensors take the plain version; CUDA
    tensors launch the schedule kernel (one block, no host sync)."""
    if probe_ids.device.type == "cpu":
        return tile_schedule_plain(probe_ids, n_tiles, chunk)
    if probe_ids.device.type != "cuda":
        raise ValueError(f"the schedule runs on cuda or cpu, not "
                         f"{probe_ids.device}")
    if probe_ids.dtype != torch.int32 or not probe_ids.is_contiguous() \
            or probe_ids.numel() == 0:
        raise ValueError("probe_ids must be a non-empty contiguous int32 "
                         "tensor")
    lib = _schedule_library()
    P = probe_ids.numel()
    dev = probe_ids.device
    keys16 = n_tiles <= torch.iinfo(torch.int16).max + 1
    with torch.cuda.device(dev):
        tiles = torch.empty(P, dtype=torch.int16 if keys16 else torch.int32,
                            device=dev)
        order = torch.empty(P, dtype=torch.int64, device=dev)
        scratch = lib.pfh_tile_schedule_scratch(n_tiles)
        counts = (torch.empty(scratch, dtype=torch.int32, device=dev)
                  if scratch else None)
        pieces = (torch.empty(1 + 2 * piece_bound(P, n_tiles, chunk),
                              dtype=torch.int32, device=dev)
                  if chunk > 0 else None)
        err = lib.pfh_tile_schedule(
            probe_ids.data_ptr(), P, n_tiles, chunk, int(keys16),
            None if counts is None else counts.data_ptr(), tiles.data_ptr(),
            order.data_ptr(), None if pieces is None else pieces.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"tile_schedule kernel launch failed: "
                           f"cudaError {err}")
    tile_schedule.launches += 1
    return (tiles, order) if pieces is None else (tiles, order, pieces)


tile_schedule.launches = 0


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfh_slab_distances.restype = i
    lib.pfh_slab_distances.argtypes = [
        p, i,                      # payload, is_bf16
        p, p, p, p,                # norms, sizes, queries, probe_ids
        p, p, i,                   # the flat pairs by tile, pieces, blocks
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
    """Raises ValueError on what the kernel does not take; ``smem(T, d)``
    gives its shared memory (None: K5's, ``slab_smem_bytes``)."""
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
    need = (slab_smem_bytes(T, d, payload.dtype) if smem is None
            else smem(T, d))
    if need > _MAX_SMEM:
        raise ValueError(f"T={T}, d={d} needs more shared memory than a "
                         f"block may use ({_MAX_SMEM} bytes)")


def sq8_smem_bytes(T: int, d: int) -> int:
    """K4's shared memory: each of the 8 warps' ring of 4 stages of 8 code
    rows with their norms; each pair of a chunk's scale⊙q [d], ‖q‖²,
    ⟨vmin, q⟩ and three ints. T does not enter: the lanes finish their own
    rows."""
    return 8 * 4 * 8 * (d + 4) + 4 * SQ8_CHUNK * (d + 2) + 12 * SQ8_CHUNK


def slab_smem_bytes(T: int, d: int, dtype: torch.dtype) -> int:
    """K5's shared memory: each warp's ring of ``SLAB_NST`` stages (bf16:
    16 rows at a stride of 2d + 16 bytes; f32: 8 rows) with the rows'
    norms; the piece's query fragments (bf16: three bf16 parts of a 16 x 8
    block per 16 features) or queries (f32); each pair's ‖q‖² and three
    ints. T does not enter."""
    if dtype == torch.bfloat16:
        stage, extra = 16 * (2 * d + 16) + 64, 8 * 3 * 32 * -(-d // 16)
    else:
        stage, extra = 8 * (4 * d + 4), 4 * SLAB_CHUNK * d
    return SLAB_WARPS * SLAB_NST * stage + extra + 16 * SLAB_CHUNK


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
    ntp1, T, d = payload.shape
    nq, max_t = probe_ids.shape
    chunk = lib.pfh_slab_chunk()
    with torch.cuda.device(payload.device):
        q = queries.to(torch.float32).contiguous()
        if lib.pfh_slab_run_aligned():
            _, order, pieces = tile_schedule(probe_ids, ntp1, chunk)
            blocks = piece_bound(nq * max_t, ntp1, chunk)
        else:
            (_, order), pieces = tile_schedule(probe_ids, ntp1), None
            blocks = -(-nq * max_t // chunk)
        out = torch.empty((nq, max_t * T), dtype=torch.float32,
                          device=payload.device)
        err = lib.pfh_slab_distances(
            payload.data_ptr(), int(payload.dtype == torch.bfloat16),
            norms.data_ptr(), sizes.data_ptr(), q.data_ptr(),
            probe_ids.data_ptr(), order.data_ptr(),
            None if pieces is None else pieces.data_ptr(), blocks,
            nq, max_t, T, d, out.data_ptr(),
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
        _, order = tile_schedule(probe_ids, payload.shape[0])
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
