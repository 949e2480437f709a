"""Multi-process sharded serving: a mesh spanning processes — the port of
prefhetch_tpu/parallel/multihost.py over ``torch.distributed``.

The single-process path (parallel/mesh.py + parallel/sharded.py) shards the
index over the devices one process owns. This module extends the same
layout across processes: every process joins a ``torch.distributed`` world,
its mesh holds its own devices and its place in the world, and the same
sharded functions run unchanged — the mesh's ``psum``/``all_gather`` add an
``all_reduce``/``all_gather`` across the world after the local combination.
The backend is NCCL for CUDA devices and gloo for the CPU. A world that fails
to form raises; nothing falls back to one process.

Every process calls the sharded functions with the same replicated inputs
(queries are replicated; only index shards are local) and gets the same
result. NCCL refuses two ranks on one GPU, so a one-card machine runs an
NCCL world of one; tests/test_torch_multihost.py runs two processes over
gloo on the CPU.

Reference baseline: none — the reference is a single process
(SURVEY.md §2.4).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from prefhetch_tpu_torch.device import resolve_device
from prefhetch_tpu_torch.parallel.mesh import AXIS, Mesh
from prefhetch_tpu_torch.parallel.sharded import (
    ShardedIndex, shard_index, shard_rows,
)


def init_multihost(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
    device: "str | torch.device" = "cuda",
    devices: Optional[Sequence["str | torch.device"]] = None,
    timeout_s: float = 120.0,
) -> Mesh:
    """Join the world whose process 0 listens at ``coordinator``
    ("host:port") and return this process's part of the GLOBAL 1-D mesh.

    Local shards: ``devices`` as given (a device may repeat), else the CUDA
    devices ``local_device_ids`` (default: all visible) or the CPU once.
    Follows the device rule: without CUDA it raises unless asked for the
    CPU. Every process must hold the same number of local shards."""
    import torch.distributed as dist

    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            ids = (range(torch.cuda.device_count())
                   if local_device_ids is None else local_device_ids)
            devs = tuple(torch.device("cuda", int(i)) for i in ids)
        else:
            devs = (dev,)
    if not devs:
        raise ValueError("a process needs at least one local device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"local devices of one type, got {devs}")
    backend = "nccl" if devs[0].type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(devs[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return Mesh(devs, rank=process_id, world=num_processes,
                group=dist.group.WORLD)


def shutdown_multihost() -> None:
    """Leave the world (destroy the default process group)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_array_global(x: np.ndarray, mesh: Mesh, spec=AXIS):
    """Host array → this process's part of a global sharded array.

    Every process calls this with the SAME full array. ``spec`` = AXIS
    (the JAX package's P("lists")) gives a ``ShardedRows`` of this process's
    row shards — remote shards are never put on a device; ``spec`` = None
    (P()) gives the array replicated on the leader device."""
    if spec is None:
        return torch.as_tensor(np.asarray(x)).to(mesh.leader)
    if spec != AXIS:
        raise ValueError(f"spec must be {AXIS!r} or None, got {spec!r}")
    return shard_rows(torch.as_tensor(np.asarray(x)), mesh)


def shard_index_multihost(index, mesh: Mesh) -> ShardedIndex:
    """Multi-process twin of parallel.sharded.shard_index: every process
    builds the same index and keeps only its own list shards (the port's
    shard_index already places only local shards)."""
    return shard_index(index, mesh)

