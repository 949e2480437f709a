"""K3: partial PQ asymmetric-distance (ADC) sums over union code tiles.

Port of the TPU kernel prefhetch_tpu/ops/pallas_scan.py
``pallas_pq_onehot_distances`` (:358-421, body ``_kernel_pq_onehot``
:330-355). For every query q, union slot u (tile = union[u]) and lane t:

    out[q, u·T + t] = Σ_m lut(q, list)[m·ksub + codes[tile, t, m]]
    lut(q, list)    = bf16(bf16(lutq[q]) + bf16(lutp[list])),
    list            = tile_list[tile]

``lutq`` and ``lutp`` are cast to bf16, their sum is rounded to bf16 again
(round to nearest even; the rounding is part of the contract) and the M terms
are summed in f32. Nothing is masked here: lanes past a tile's size hold
whatever their codes give; the caller adds the per-(query, list) scalar,
clamps and masks (ops/union_scan.union_pq_scan_distances_kernel). The TPU
kernel multiplies a one-hot of the codes with the LUT on its matrix unit; on
the card the same function is a table lookup out of shared memory
(``csrc/pq_onehot.cu``). The TPU kernel's query-block padding is a grid
artefact and is dropped: any nq.

``pq_onehot_distances`` picks by the device of its tensors: CPU tensors take
the plain PyTorch version (``pq_onehot_distances_plain``), CUDA tensors
launch the hand-written kernel (nvcc for sm_90a, bound with ctypes, built at
first use) or raise. There is no fallback from the kernel to the plain
version. ``pq_onehot_distances.launches`` counts kernel launches and
``pq_onehot_distances_plain.calls`` counts plain-version calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_LIB = "pq_onehot"
_MAX_SMEM = 232448                  # bytes a block may opt into on sm_90
_PLAIN_CHUNK_ELEMS = 1 << 24        # gather index elements per chunk of tiles


def adc_lookup_sum(
    codes: torch.Tensor,        # [ntiles+1, T, M] uint8
    lutq: torch.Tensor,         # [nq, MK] f32 or bf16
    lutp: Optional[torch.Tensor],   # [nlist, MK], same type; None = no part
    tile_list: torch.Tensor,    # [ntiles+1] int32
    union: torch.Tensor,        # [U] int32
) -> torch.Tensor:
    """out[q, u, t] = Σ_m (lutq[q] + lutp[list(u)])[m·ksub + code[u, t, m]]
    as f32 [nq, U, T]: the table is summed in the type it is given in (a
    bf16 sum rounds to bf16), looked up by code and the M terms are summed
    in f32. The formula that K3's plain version and the exact f32 ADC scan
    of ops/union_scan.py share; a chunk of union tiles at a time."""
    _, T, M = codes.shape
    nq, MK = lutq.shape
    ksub = MK // M
    U = union.shape[0]
    u = union.long()
    lists = tile_list.long()[u]                               # [U]
    m_offset = torch.arange(M, device=codes.device) * ksub
    out = torch.empty((nq, U, T), dtype=torch.float32, device=codes.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (nq * T * M))
    for s in range(0, U, chunk):
        c = codes[u[s:s + chunk]].long() + m_offset           # [c, T, M]
        lut = lutq[None]                                      # [1, nq, MK]
        if lutp is not None:
            lut = lut + lutp[lists[s:s + chunk]][:, None]     # [c, nq, MK]
        lut = lut.to(torch.float32)
        n = c.shape[0]
        idx = c.reshape(n, 1, T * M).expand(n, nq, T * M)
        vals = torch.gather(lut.expand(n, nq, MK), 2, idx)
        out[:, s:s + chunk] = vals.reshape(n, nq, T, M).sum(-1).transpose(0, 1)
    return out


def pq_onehot_distances_plain(
    codes: torch.Tensor,        # [ntiles+1, T, M] uint8
    lutq: torch.Tensor,         # [nq, MK] f32/bf16 — per-query LUT part
    lutp: torch.Tensor,         # [nlist, MK] f32/bf16 — per-list LUT part
    tile_list: torch.Tensor,    # [ntiles+1] int32
    union: torch.Tensor,        # [U] int32
) -> torch.Tensor:
    """Plain PyTorch version of K3: partial ADC sums [nq, U·T] f32."""
    pq_onehot_distances_plain.calls += 1
    out = adc_lookup_sum(codes, lutq.to(torch.bfloat16),
                         lutp.to(torch.bfloat16), tile_list, union)
    return out.reshape(lutq.shape[0], -1)


pq_onehot_distances_plain.calls = 0


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfh_pq_onehot.restype = i
    lib.pfh_pq_onehot.argtypes = [
        p, p, p, p, p,             # codes, lutq, lutp, tile_list, union
        i, i, i, i, i,             # nq, U, T, M, ksub
        i, i,                      # qb, ny
        p, p,                      # out, stream
    ]
    return lib


def smem_bytes(MK: int, qb: int) -> int:
    """Shared memory of one block: qb interleaved query tables and one list
    table, bf16."""
    return 2 * MK * (qb + 1)


def _check(codes, lutq, lutp, tile_list, union) -> None:
    dev = codes.device
    for name, t in (("lutq", lutq), ("lutp", lutp),
                    ("tile_list", tile_list), ("union", union)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes on {dev}")
    if codes.dtype != torch.uint8 or codes.dim() != 3 \
            or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous uint8 [ntiles+1, T, M]")
    ntp1, T, M = codes.shape
    if codes.data_ptr() % 16 != 0:
        raise ValueError("codes must be 16-byte aligned")
    if lutq.dim() != 2 or lutq.shape[0] == 0 or lutq.shape[1] % M != 0:
        raise ValueError(f"lutq must be [nq, M·ksub] with nq > 0, M={M}")
    MK = lutq.shape[1]
    if MK // M > 256:
        raise ValueError("uint8 codes address at most 256 codewords")
    if lutp.dim() != 2 or lutp.shape[1] != MK:
        raise ValueError(f"lutp must be [nlist, {MK}]")
    for name, t in (("lutq", lutq), ("lutp", lutp)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be f32 or bf16, got {t.dtype}")
    if tile_list.dtype != torch.int32 or tuple(tile_list.shape) != (ntp1,) \
            or not tile_list.is_contiguous():
        raise ValueError("tile_list must be a contiguous int32 [ntiles+1]")
    if union.dtype != torch.int32 or union.dim() != 1 \
            or not union.is_contiguous() or union.shape[0] == 0:
        raise ValueError("union must be a non-empty contiguous int32 [U]")
    if smem_bytes(MK, 1) > _MAX_SMEM:
        raise ValueError(f"M·ksub={MK}: two bf16 tables exceed the shared "
                         f"memory a block may use ({_MAX_SMEM} bytes)")


def pq_onehot_distances(
    codes: torch.Tensor,        # [ntiles+1, T, M] uint8
    lutq: torch.Tensor,         # [nq, MK] f32/bf16 — per-query LUT part
    lutp: torch.Tensor,         # [nlist, MK] f32/bf16 — per-list LUT part
    tile_list: torch.Tensor,    # [ntiles+1] int32, each < nlist
    union: torch.Tensor,        # [U] int32 tile ids, each < ntiles+1
) -> torch.Tensor:
    """K3 on the tensors' device: partial ADC sums [nq, U·T] f32,
    query-major (reshape to [nq, U, T]). A block keeps the tables of 8, 4, 2
    or 1 queries in shared memory: the most that fit at this M·ksub."""
    if codes.device.type == "cpu":
        return pq_onehot_distances_plain(codes, lutq, lutp, tile_list, union)
    if codes.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu, not {codes.device}")
    _check(codes, lutq, lutp, tile_list, union)
    _, T, M = codes.shape
    nq, MK = lutq.shape
    U = union.shape[0]
    qb = next(b for b in (8, 4, 2, 1) if smem_bytes(MK, b) <= _MAX_SMEM)
    lib = _library()
    with torch.cuda.device(codes.device):
        # one wave of blocks: each block keeps its queries' tables for its
        # whole life and walks an equal share of the union
        props = torch.cuda.get_device_properties(codes.device)
        per_sm = max(1, _MAX_SMEM // (smem_bytes(MK, qb) + 1024))
        nqb = -(-nq // qb)
        ny = max(1, min(U, props.multi_processor_count * per_sm // nqb))
        lq = lutq.to(torch.bfloat16).contiguous()
        lp = lutp.to(torch.bfloat16).contiguous()
        out = torch.empty((nq, U * T), dtype=torch.float32,
                          device=codes.device)
        err = lib.pfh_pq_onehot(
            codes.data_ptr(), lq.data_ptr(), lp.data_ptr(),
            tile_list.data_ptr(), union.data_ptr(), nq, U, T, M, MK // M,
            qb, ny, out.data_ptr(),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pq_onehot kernel launch failed: cudaError {err}")
    pq_onehot_distances.launches += 1
    return out


pq_onehot_distances.launches = 0
