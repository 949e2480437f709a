"""Multi-process sharding of the port: a REAL 2-process torch.distributed
world — the counterpart of tests/test_multihost.py.

Two subprocesses each hold 2 local CPU shards (``devices=["cpu", "cpu"]``);
the world mesh of 4 shards spans both, and the sharded services combine
with gloo collectives (``init_multihost``). In every process each result
equals, bit for bit, the same function on a one-process mesh of 4 shards
and the unsharded function; the k-means step's means agree to rtol 1e-4.
Each process has its own timeout and is killed if it overruns."""

import os
import socket
import subprocess
import sys

_WORKER = r'''
import sys
import numpy as np
import torch

torch.set_num_threads(1)
pid, port = int(sys.argv[1]), sys.argv[2]
from prefhetch_tpu_torch.parallel.multihost import (
    init_multihost, shard_array_global, shard_index_multihost,
    shutdown_multihost,
)
from prefhetch_tpu_torch.parallel.mesh import make_mesh
from prefhetch_tpu_torch.parallel import sharded as S

mesh = init_multihost(f"127.0.0.1:{port}", 2, pid, device="cpu",
                      devices=["cpu", "cpu"], timeout_s=120)
assert mesh.ndev == 4 and mesh.world == 2, mesh
local4 = make_mesh(devices=["cpu"] * 4)

from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
from prefhetch_tpu_torch.index.build import build_ivf_index
from prefhetch_tpu_torch.index.tiling import build_tiled_view
from prefhetch_tpu_torch.ops.rerank import exact_rerank
from prefhetch_tpu_torch.ops.union_scan import (
    union_probe_tiles, union_scan_pruned_fused,
)
from prefhetch_tpu_torch.utils.config import IndexParams

# identical deterministic build in every process
data = make_clustered_dataset(nbase=1600, ntrain=1600, nquery=4, d=32,
                              n_clusters=16, gt_k=10, seed=5)
index = build_ivf_index(data["train"], data["base"],
                        IndexParams(d=32, nlist=16, pq_m=8, kmeans_iters=5,
                                    pq_kmeans_iters=5), device="cpu")
q = torch.from_numpy(data["query"][:4].astype(np.float32))
cent = index.centroids.numpy()
probes = torch.from_numpy(np.argsort(
    ((q.numpy()[:, None] - cent[None]) ** 2).sum(-1), axis=1)[:, :4])


def same(a, b, what):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and torch.equal(a, b), (pid, what)


sh_w, sh_l = shard_index_multihost(index, mesh), S.shard_index(index, local4)
assert len(sh_w.shards) == 2
rw, rl = S.sharded_coarse_scan(mesh, sh_w, q, probes), \
    S.sharded_coarse_scan(local4, sh_l, q, probes)
for f in rw._fields:
    same(getattr(rw, f), getattr(rl, f), f)

base = data["base"]
bw, bl = shard_array_global(base, mesh), S.shard_rows(base, local4)
assert len(bw.shards) == 2 and bw.shards[0].shape[0] == 400
cand = torch.from_numpy(np.tile(np.arange(32)[None], (4, 1)).astype(np.int32))
same(S.sharded_rerank(mesh, bw, q, cand),
     exact_rerank(torch.from_numpy(base), q, cand), "rerank")
same(S.sharded_fetch(mesh, bw, cand[:, :5]),
     S.sharded_fetch(local4, bl, cand[:, :5]), "fetch")
cw, nw = S.sharded_kmeans_step(mesh, bw, index.centroids)
cl, nl = S.sharded_kmeans_step(local4, bl, index.centroids)
same(nw, nl, "kmeans counts")
assert torch.allclose(cw, cl, rtol=1e-4, atol=1e-3), pid

view = build_tiled_view(index, tile=64)
tiles, _ = view.expand_probes(probes.numpy().astype(np.int64))
union, pos = union_probe_tiles(tiles, view.empty_tile)
stw, stl = S.shard_tiled_view(view, mesh), S.shard_tiled_view(view, local4)
ud, pd, _ = S.partition_union(union, pos, view.empty_tile, stw.tpl, 4)
same(S.sharded_union_scan(mesh, stw, q, ud, pd),
     S.sharded_union_scan(local4, stl, q, ud, pd), "union scan")
got = S.sharded_union_scan_pruned(mesh, stw, q, ud, pd, 3)
want = union_scan_pruned_fused(
    view.payload, view.norms, view.sizes, q,
    torch.from_numpy(union.astype(np.int32)), torch.from_numpy(pos), 3)
for a, b in zip(got, want):
    same(a, b, "pruned union scan")
for a, b in zip(S.sharded_fused_tail(mesh, bw, q, cand, 8),
                S.sharded_fused_tail(local4, bl, q, cand, 8)):
    same(a, b, "fused tail")

from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.engine.hecompute import HEComputeService
from prefhetch_tpu_torch.utils.config import HEParams

rng = np.random.default_rng(21)
eb = rng.integers(0, 256, (320, 32)).astype(np.float32)
eq = rng.integers(0, 256, (4, 32)).astype(np.float32)
eidx = np.stack([rng.permutation(320)[:8] for _ in range(4)]).astype(
    np.int32)
hc = HEClient(HEParams(n=256, sparse_h=48, resp_mod="q1"), seed=5)
svc = HEComputeService(hc.params, device="cpu")
svc.set_base(eb)
ctq, _, _ = svc._prepare(
    [svc.ctx.ct_from_wire(w) for w in hc.encrypt_query_batch(eq)], eidx)
bp = S.pad_rows_for_mesh(svc._base_host, 4)
same(S.sharded_trunc_mac_q1(mesh, shard_array_global(bp, mesh), ctq, eidx,
                            svc.params),
     torch.from_numpy(svc._trunc_mac_q1_numpy(ctq[:, 0], ctq[:, 1], eidx)),
     "q1 MAC")

from prefhetch_tpu_torch.crypto.params import pir_params_for
from prefhetch_tpu_torch.crypto.pir import PIRClient
from prefhetch_tpu_torch.engine.pir_device import DevicePIR2

pp = pir_params_for(256, 257, 2)
pb = rng.integers(0, 256, (512, 32)).astype(np.float32)
pcl = PIRClient(pp, seed=9)
pdev = DevicePIR2(pb, pp, device="cpu")
pdev.register_galois_keys(pcl.key_id, pcl.galois_keys_wire_2d(512, 32))
pw, pr = pcl.build_query_2d(37, 512, 32)
assert pdev.answer_2d_sharded(pw, pcl.key_id, mesh) == \
    pdev.answer_2d(pw, pcl.key_id), pid

shutdown_multihost()
print(f"pid{pid}: MULTIHOST_OK", flush=True)
'''


def test_two_process_gloo_world(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo_root)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=repo_root,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid{pid} failed:\n{out[-3000:]}"
        assert f"pid{pid}: MULTIHOST_OK" in out, out[-3000:]


_LONE_RANK = r'''
import sys
from prefhetch_tpu_torch.parallel.multihost import init_multihost

try:
    init_multihost(f"127.0.0.1:{sys.argv[1]}", 2, 0, device="cpu",
                   timeout_s=3)
except Exception as e:
    print("RAISED", type(e).__name__, flush=True)
    sys.exit(0)
print("FORMED ALONE", flush=True)
sys.exit(1)
'''


def test_a_world_that_cannot_form_raises(tmp_path):
    """Rank 0 of a world of 2 whose other rank never comes: init_multihost
    raises at its timeout; nothing falls back to one process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "lone.py"
    script.write_text(_LONE_RANK)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, str(script), port], capture_output=True,
        env=dict(os.environ, PYTHONPATH=repo_root), cwd=repo_root,
        timeout=120)
    out = (run.stdout + run.stderr).decode(errors="replace")
    assert run.returncode == 0 and "RAISED" in out, out[-2000:]
