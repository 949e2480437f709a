"""K3: the PQ-code scan over each query's probed tiles, epilogue fused.

Port of the TPU kernel prefhetch_tpu/ops/pallas_scan.py
``pallas_pq_onehot_distances`` (:358-421, body ``_kernel_pq_onehot``
:330-355) together with the epilogue of the JAX stage that calls it,
prefhetch_tpu/ops/union_scan.py ``union_pq_scan_distances_pallas``
(:435-500). For every query q, probe slot s (tile = tiles[q, s],
L = tile_list[tile]) and lane t:

    out[q, s·T + t] = max(cadd[q, L] + Σ_m lut(q, L)[m·ksub + codes[tile, t, m]], 0)
                      for t < sizes[tile], PAD otherwise
    lut(q, L)       = bf16(bf16(lutq[q]) + bf16(lutp[L]))

``lutq`` and ``lutp`` are cast to bf16, their sum is rounded to bf16 again
(round to nearest even; the rounding is part of the contract) and the M
terms are summed in f32. The output is f32 [nq, max_t·T], the layout that
``topk_select_segmented`` takes.

The TPU kernel scores every query against every tile of the batch's union
with a one-hot product on its matrix unit, and the JAX stage then keeps each
query's own slots. The card computes only the (query, probed slot) pairs, as
shared-memory table lookups (``csrc/pq_onehot.cu``).
``pq_probed_distances_plain`` is that two-step composition itself:
``pq_onehot_distances_plain`` (the union form, held against the Pallas
kernel in the tests) over the union of ``tiles``, then ``pq_finish``.

``pq_probed_distances`` picks by the device of its tensors: CPU tensors take
the plain version, CUDA tensors launch the hand-written kernel (nvcc for
sm_90a, bound with ctypes, built at first use) or raise. There is no
fallback from the kernel to the plain version.
``pq_probed_distances.launches`` counts kernel launches and
``pq_probed_distances_plain.calls`` counts plain-version calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from prefhetch_tpu_torch.ops.topk import PAD_DISTANCE

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
    """The TPU kernel's function in plain PyTorch: partial ADC sums of every
    query over every union tile, [nq, U·T] f32, bf16 tables, unmasked."""
    out = adc_lookup_sum(codes, lutq.to(torch.bfloat16),
                         lutp.to(torch.bfloat16), tile_list, union)
    return out.reshape(lutq.shape[0], -1)


def pq_finish(part, cadd, sizes, tile_list, union, pos) -> torch.Tensor:
    """Partial ADC sums [nq, U, T] → distances [nq, max_t·T]: add the
    per-(query, list) scalar, clamp at 0, PAD past each tile's size, take
    each query's tiles by position into the union."""
    nq, _, T = part.shape
    u = union.long()
    lists_u = tile_list.long()[u]                             # [U]
    d2 = torch.clamp(part + cadd[:, lists_u][:, :, None], min=0.0)
    lane = torch.arange(T, device=part.device)
    valid = lane[None, :] < sizes[u][:, None]                 # [U, T]
    d2 = torch.where(valid[None], d2, PAD_DISTANCE)
    idx = pos.long()[:, :, None].expand(-1, -1, T)
    return torch.gather(d2, 1, idx).reshape(nq, -1)


def pq_probed_distances_plain(
    codes: torch.Tensor,        # [ntiles+1, T, M] uint8
    lutq: torch.Tensor,         # [nq, MK] f32/bf16
    lutp: torch.Tensor,         # [nlist, MK] f32/bf16
    cadd: torch.Tensor,         # [nq, nlist] f32
    sizes: torch.Tensor,        # [ntiles+1] int32
    tile_list: torch.Tensor,    # [ntiles+1] int32
    tiles: torch.Tensor,        # [nq, max_t] int32
) -> torch.Tensor:
    """Plain PyTorch version of K3: the union form over the union of
    ``tiles``, then the scalar, clamp, mask and extraction."""
    pq_probed_distances_plain.calls += 1
    union, pos = torch.unique(tiles, return_inverse=True)
    part = pq_onehot_distances_plain(codes, lutq, lutp, tile_list,
                                     union.to(torch.int32))
    nq, T = tiles.shape[0], codes.shape[1]
    return pq_finish(part.reshape(nq, -1, T), cadd, sizes, tile_list, union,
                     pos.reshape(tiles.shape))


pq_probed_distances_plain.calls = 0


def _library() -> ctypes.CDLL:
    from prefhetch_tpu_torch.utils.cuda_build import load

    lib = load(_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfh_pq_probed.restype = i
    lib.pfh_pq_probed.argtypes = [
        p, p, p, p,                # codes, lutq, lutp, cadd
        p, p, p,                   # sizes, tile_list, tiles
        i, i, i, i, i, i,          # nq, max_t, T, M, ksub, nlist
        p, p,                      # out, stream
    ]
    return lib


def _check(codes, lutq, lutp, cadd, sizes, tile_list, tiles) -> None:
    dev = codes.device
    for name, t in (("lutq", lutq), ("lutp", lutp), ("cadd", cadd),
                    ("sizes", sizes), ("tile_list", tile_list),
                    ("tiles", tiles)):
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
    nq, MK = lutq.shape
    if MK // M > 256:
        raise ValueError("uint8 codes address at most 256 codewords")
    if lutp.dim() != 2 or lutp.shape[1] != MK:
        raise ValueError(f"lutp must be [nlist, {MK}]")
    for name, t in (("lutq", lutq), ("lutp", lutp)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be f32 or bf16, got {t.dtype}")
    if cadd.dtype != torch.float32 or tuple(cadd.shape) != (nq, lutp.shape[0]):
        raise ValueError(f"cadd must be f32 [{nq}, {lutp.shape[0]}]")
    for name, t in (("sizes", sizes), ("tile_list", tile_list)):
        if t.dtype != torch.int32 or tuple(t.shape) != (ntp1,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [ntiles+1]")
    if tiles.dtype != torch.int32 or tiles.dim() != 2 \
            or tiles.shape[0] != nq or tiles.shape[1] == 0 \
            or not tiles.is_contiguous():
        raise ValueError(f"tiles must be a contiguous int32 [{nq}, max_t] "
                         f"with max_t > 0")
    if nq > 65535:
        raise ValueError(f"K3 takes at most 65535 queries a call, got {nq}")
    if 2 * MK > _MAX_SMEM:              # a block's one bf16 table
        raise ValueError(f"M·ksub={MK}: the bf16 table exceeds the shared "
                         f"memory a block may use ({_MAX_SMEM} bytes)")


def pq_probed_distances(
    codes: torch.Tensor,        # [ntiles+1, T, M] uint8
    lutq: torch.Tensor,         # [nq, MK] f32/bf16 — per-query LUT part
    lutp: torch.Tensor,         # [nlist, MK] f32/bf16 — per-list LUT part
    cadd: torch.Tensor,         # [nq, nlist] f32 — per-(query, list) scalar
    sizes: torch.Tensor,        # [ntiles+1] int32
    tile_list: torch.Tensor,    # [ntiles+1] int32, each < nlist
    tiles: torch.Tensor,        # [nq, max_t] int32 tile ids, each < ntiles+1
) -> torch.Tensor:
    """K3 on the tensors' device: distances [nq, max_t·T] f32 with PAD past
    each tile's size."""
    if codes.device.type == "cpu":
        return pq_probed_distances_plain(codes, lutq, lutp, cadd, sizes,
                                         tile_list, tiles)
    if codes.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu, not {codes.device}")
    cadd = cadd.contiguous()
    _check(codes, lutq, lutp, cadd, sizes, tile_list, tiles)
    _, T, M = codes.shape
    nq, MK = lutq.shape
    max_t = tiles.shape[1]
    lib = _library()
    with torch.cuda.device(codes.device):
        lq = lutq.to(torch.bfloat16).contiguous()
        lp = lutp.to(torch.bfloat16).contiguous()
        out = torch.empty((nq, max_t * T), dtype=torch.float32,
                          device=codes.device)
        err = lib.pfh_pq_probed(
            codes.data_ptr(), lq.data_ptr(), lp.data_ptr(), cadd.data_ptr(),
            sizes.data_ptr(), tile_list.data_ptr(), tiles.data_ptr(),
            nq, max_t, T, M, MK // M, lutp.shape[0], out.data_ptr(),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pq_probed kernel launch failed: cudaError {err}")
    pq_probed_distances.launches += 1
    return out


pq_probed_distances.launches = 0
