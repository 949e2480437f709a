"""Sharding over a device mesh — the port of prefhetch_tpu/parallel/."""

from prefhetch_tpu_torch.parallel.mesh import AXIS, Mesh, make_mesh  # noqa: F401
from prefhetch_tpu_torch.parallel.sharded import (  # noqa: F401
    shard_index,
    shard_rows,
    sharded_coarse_scan,
    sharded_fetch,
    sharded_kmeans_step,
    sharded_rerank,
)
