"""Multi-shard dry run — the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

    python -m prefhetch_tpu_torch.parallel.dryrun N [--device cuda|cpu]

One sharded train + query step over a mesh of N shards on one device (the
port's stand-in for the JAX package's virtual N-device CPU backend; on a
machine with N cards pass the mesh's devices to the functions directly):
the data-parallel k-means step, the list-sharded coarse scan, the
row-sharded re-rank and fetch, the tile-sharded union scans (f32, q16 and
the pruned one on kernel K1, once a shard), the fused tail, the
query-sharded BFV q1 MAC (K2) and the PIR answer with the database sharded
over its dim-1 fold (K2), each against the same function on one device:
bit-equal, except the k-means means (f32 sums in another order; rtol 1e-4,
as the JAX test holds them). Any disagreement raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from prefhetch_tpu_torch.device import resolve_device


def _equal(a, b, what: str) -> None:
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"sharded {what} not bit-equal to one device")


def dryrun_multichip(n_devices: int,
                     device: "str | torch.device" = "cuda") -> dict:
    """Run the dry run on a mesh of ``n_devices`` shards of ``device`` →
    a summary dict with "ok": True; raises on any disagreement."""
    from prefhetch_tpu_torch.client.he import HEClient
    from prefhetch_tpu_torch.crypto.params import pir_params_for
    from prefhetch_tpu_torch.crypto.pir import PIRClient, grid_dims
    from prefhetch_tpu_torch.data.synthetic import make_clustered_dataset
    from prefhetch_tpu_torch.engine.hecompute import HEComputeService
    from prefhetch_tpu_torch.engine.pir_device import DevicePIR2
    from prefhetch_tpu_torch.index.build import build_ivf_index
    from prefhetch_tpu_torch.index.tiling import build_tiled_view
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import union_scan_min as usm
    from prefhetch_tpu_torch.ops.distances import rank_centroids
    from prefhetch_tpu_torch.ops.rerank import (
        exact_rerank, fetch_vectors, final_topk,
    )
    from prefhetch_tpu_torch.ops.scan import coarse_scan_flat
    from prefhetch_tpu_torch.ops.topk import topk_select
    from prefhetch_tpu_torch.ops.union_scan import (
        resolve_topk_ids, union_probe_tiles, union_scan_distances,
        union_scan_distances_q16, union_scan_pruned_fused,
    )
    from prefhetch_tpu_torch.parallel.mesh import make_mesh
    from prefhetch_tpu_torch.parallel.sharded import (
        pad_rows_for_mesh, partition_union, shard_index, shard_rows,
        shard_tiled_view, sharded_coarse_scan, sharded_fetch, sharded_fused_tail,
        sharded_kmeans_step, sharded_rerank, sharded_trunc_mac_q1,
        sharded_union_scan, sharded_union_scan_pruned,
        sharded_union_scan_q16,
    )
    from prefhetch_tpu_torch.utils.config import HEParams, IndexParams

    dev = resolve_device(device)
    mesh = make_mesh(devices=[dev] * n_devices)
    one = make_mesh(devices=[dev])
    k1_0, k2_0 = usm.union_scan_min.launches, k2.ntt4_transform.launches

    # the JAX dry run's shapes: 64K base vectors, 128 lists, d=128
    nbase, nlist, d, nq = 65536, max(128, 2 * n_devices), 128, 8
    data = make_clustered_dataset(nbase=nbase, ntrain=8192, nquery=nq, d=d,
                                  n_clusters=max(8, nlist), gt_k=10, seed=3)
    params = IndexParams(d=d, nlist=nlist, pq_m=16, pq_nbits=8,
                         kmeans_iters=5, pq_kmeans_iters=5)
    index = build_ivf_index(data["train"], data["base"], params, dev)
    base = torch.from_numpy(data["base"]).to(dev)
    q = torch.from_numpy(data["query"].astype(np.float32)).to(dev)

    # 1) training step: data-parallel Lloyd iteration
    x_sh = shard_rows(base, mesh)
    new_c, counts = sharded_kmeans_step(mesh, x_sh, index.centroids)
    ref_c, ref_counts = sharded_kmeans_step(one, shard_rows(base, one),
                                            index.centroids)
    if not bool(torch.isfinite(new_c).all()) \
            or int(counts.sum()) != nbase:
        raise AssertionError("sharded k-means step: non-finite or lost rows")
    _equal(counts, ref_counts, "k-means counts")
    if not torch.allclose(new_c, ref_c, rtol=1e-4, atol=1e-3):
        raise AssertionError("sharded k-means means beyond rtol 1e-4")

    # 2) list-sharded scan, row-sharded re-rank and fetch
    _, probe = rank_centroids(q, index.centroids, 8)
    res = sharded_coarse_scan(mesh, shard_index(index, mesh), q, probe)
    ref = coarse_scan_flat(index.list_recon, index.list_ids,
                           index.list_sizes, q, probe, index.list_norms)
    for f in res._fields:
        _equal(getattr(res, f), getattr(ref, f), f"coarse scan {f}")
    cand = torch.where(res.ids[:, :64] >= 0, res.ids[:, :64], 0)
    _equal(sharded_rerank(mesh, x_sh, q, cand),
           exact_rerank(base, q, cand), "re-rank")
    _equal(sharded_fetch(mesh, x_sh, cand[:, :4]),
           fetch_vectors(base, cand[:, :4]), "fetch")

    # 3) the tiled serving path: tile-sharded union scans + fused tail
    view = build_tiled_view(index, tile=128)
    tiles_np, _ = view.expand_probes(probe.cpu().numpy().astype(np.int64))
    union_np, pos_np = union_probe_tiles(tiles_np, view.empty_tile)
    union = torch.from_numpy(union_np.astype(np.int32)).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    st = shard_tiled_view(view, mesh)
    union_dev, pos_dev, u_loc = partition_union(
        union_np, pos_np, view.empty_tile, st.tpl, mesh.ndev)
    args = (view.payload, view.norms, view.sizes, q, union, pos)
    dist = sharded_union_scan(mesh, st, q, union_dev, pos_dev)
    _equal(dist, union_scan_distances(*args), "tiled union scan")
    for a, b in zip(sharded_union_scan_q16(mesh, st, q, union_dev, pos_dev),
                    union_scan_distances_q16(*args)):
        _equal(a, b, "tiled q16 scan")
    j = max(1, tiles_np.shape[1] // 4)
    k1_before = usm.union_scan_min.launches
    got = sharded_union_scan_pruned(mesh, st, q, union_dev, pos_dev, j)
    k1_pruned = usm.union_scan_min.launches - k1_before
    for a, b in zip(got, union_scan_pruned_fused(*args, j)):
        _equal(a, b, "pruned union scan (K1)")
    if dev.type == "cuda" and k1_pruned != n_devices:
        raise AssertionError(f"K1 launched {k1_pruned} times for "
                             f"{n_devices} shards")
    _, pos_t = topk_select(dist, 64)
    tiles = torch.from_numpy(tiles_np).to(dev)
    cand_t = resolve_topk_ids(pos_t, tiles, st.ids)
    for a, b in zip(sharded_fused_tail(mesh, x_sh, q, cand_t, 16),
                    final_topk(exact_rerank(base, q, cand_t), cand_t, 16)):
        _equal(a, b, "fused tail")

    # 4) encrypted services: the q1 MAC query-sharded, the PIR fold
    #    database-sharded, both exact integer arithmetic, at N=4096 (the
    #    JAX dry run's N=256 is below the smallest ring K2 takes)
    n_he = 4096
    rng = np.random.default_rng(21)
    eb = rng.integers(0, 256, (320, 32)).astype(np.float32)
    eq = rng.integers(0, 256, (n_devices, 32)).astype(np.float32)
    eidx = np.stack([rng.permutation(320)[:8]
                     for _ in range(n_devices)]).astype(np.int32)
    hc = HEClient(HEParams(n=n_he, sparse_h=48, resp_mod="q1"), seed=5)
    svc = HEComputeService(hc.params, device=dev)
    svc.set_base(eb)
    ctq, eidx, _ = svc._prepare(
        [svc.ctx.ct_from_wire(w) for w in hc.encrypt_query_batch(eq)],
        eidx)                             # padded to a block with the zero row
    want = svc._trunc_mac_q1_numpy(ctq[:, 0], ctq[:, 1], eidx)
    base_sh = shard_rows(pad_rows_for_mesh(svc._base_host, n_devices), mesh)
    k2_before = k2.ntt4_transform.launches
    got = sharded_trunc_mac_q1(mesh, base_sh, ctq, eidx, svc.params)
    k2_mac = k2.ntt4_transform.launches - k2_before
    _equal(got, torch.from_numpy(want), "BFV q1 MAC")

    pp = pir_params_for(n_he, 257, 2)
    pb = rng.integers(0, 256, (64 * (n_he // 32), 32)).astype(np.float32)
    if grid_dims(pp, pb.shape[0], 32)[1] % n_devices:
        raise ValueError(f"the PIR grid's g1 does not divide by {n_devices}")
    pcl = PIRClient(pp, seed=9)
    pdev = DevicePIR2(pb, pp, device=dev)
    pdev.register_galois_keys(pcl.key_id,
                              pcl.galois_keys_wire_2d(pb.shape[0], 32))
    pw, pr = pcl.build_query_2d(37, pb.shape[0], 32)
    want_pir = pdev.answer_2d(pw, pcl.key_id)
    k2_before = k2.ntt4_transform.launches
    got_pir = pdev.answer_2d_sharded(pw, pcl.key_id, mesh)
    k2_pir = k2.ntt4_transform.launches - k2_before
    if got_pir != want_pir:
        raise AssertionError("sharded PIR answer not bit-equal to one device")
    if not np.array_equal(pcl.decode_response_2d(got_pir, 32, pr),
                          np.round(pb[37]).astype(np.int64)):
        raise AssertionError("sharded PIR answer does not decode to its row")

    return {
        "ok": True, "n_devices": n_devices, "device": str(dev),
        "nbase": nbase, "nlist": nlist, "u_loc": u_loc,
        "k1_launches": usm.union_scan_min.launches - k1_0,
        "k1_pruned_scan": k1_pruned,
        "k2_launches": k2.ntt4_transform.launches - k2_0,
        "k2_q1_mac": k2_mac, "k2_pir_sharded": k2_pir,
        "counts": res.counts.cpu().tolist(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(a.n_devices, a.device)))


if __name__ == "__main__":
    main()
