"""A cell cut to a size the CPU runs in seconds, for the harness's tests:
8,192 vectors in 16 clusters, 64 lists, 8 probes."""

from anns_bench.cell import load_cell


def small_cell(name: str):
    cell = load_cell(name)
    cell.config["dataset"].update(nbase=8192, ntrain=8192, nquery=512,
                                  n_clusters=16)
    cell.config["index"]["nlist"] = 64
    cell.config["protocol"]["nprobe"] = 8
    mix = cell.traffic
    mix["warm_requests"] = 1
    if "batches_per_client" in mix:
        mix.update(batches_per_client=1, clients=1)
    return cell
