"""Device mesh — the port of prefhetch_tpu/parallel/mesh.py.

The reference has no multi-device compute at all (SURVEY.md §2.4): its only
process boundary is the client↔server HTTP hop. The index is partitioned
over a 1-D ``lists`` axis of shards; queries are replicated; per-shard
results combine by collectives.

A ``Mesh`` holds this process's devices in order, one a shard, and the world
it belongs to: its rank, the world size and the ``torch.distributed`` process
group (none for one process). Global shard ``rank·len(devices) + i`` lives on
``devices[i]``. A ``shard_map`` body of the JAX package becomes a function
run over the local shards in order; the collectives are the methods below:
``psum`` sums the local parts on the leader device (``devices[0]``), then
``all_reduce``s across processes; ``all_gather`` concatenates them in global
shard order. Results land on the leader.

One device may stand for several shards (``devices=["cpu"] * 4`` or
``["cuda:0"] * 4``): the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count``, which its tests and dry run use to
get a mesh of several devices on one CPU. Shards on one device are slices of
the unsharded tensors, not copies (only a last shard that the rows do not
fill is a zero-padded copy, parallel/sharded.shard_rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from prefhetch_tpu_torch.device import resolve_device

AXIS = "lists"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """1-D mesh: this process's shard devices and its place in the world."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    group: Any = None          # torch.distributed group; None = one process

    @property
    def ndev(self) -> int:
        """Shards in the whole mesh, over every process."""
        return len(self.devices) * self.world

    @property
    def leader(self) -> torch.device:
        """Where replicated inputs and combined results live."""
        return self.devices[0]

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """(global shard id, device) of this process's shards, in order."""
        base = self.rank * len(self.devices)
        return [(base + i, d) for i, d in enumerate(self.devices)]

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of every shard's part (one a local shard, equal shapes) on the
        leader device."""
        acc = parts[0].to(self.leader, copy=True)
        for p in parts[1:]:
            acc += p.to(self.leader)
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=self.group)
        return acc

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's part (equal shapes) concatenated along dim 0 in
        global shard order, on the leader device."""
        local = torch.cat([p.to(self.leader) for p in parts])
        if self.group is None:
            return local
        import torch.distributed as dist

        out = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(out, local.contiguous(), group=self.group)
        return torch.cat(out)


def make_mesh(
    n_devices: Optional[int] = None,
    device: "str | torch.device" = "cuda",
    devices: Optional[Sequence["str | torch.device"]] = None,
) -> Mesh:
    """1-D mesh of one process over the first n visible devices of
    ``device``'s type (default: all), or over ``devices`` as given (a device
    may repeat). Follows the device rule: without CUDA it raises unless
    asked for the CPU."""
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(
                f"n_devices={n_devices} but {len(devs)} devices given"
            )
        return Mesh(devs)
    dev = resolve_device(device)
    if dev.type == "cuda":
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [dev]
    if n_devices is not None:
        if len(avail) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(avail)} "
                "(pass devices= naming one device several times for CPU "
                "testing)"
            )
        avail = avail[:n_devices]
    return Mesh(tuple(avail))
