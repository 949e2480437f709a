"""The union scan stage's share of its roofline: the contract's bound
(roofline.scan_work: inputs once, returned outputs once) over the device
time of every kernel launched inside union_scan_pruned_fused, summed over
the kept calls of the window, replayed under torch.profiler."""


def read(run):
    calls = (run.replay or {}).get("scan") or []
    dev = sum(c[1] for c in calls)
    if dev <= 0:
        return None
    return 100.0 * sum(c[0] for c in calls) / dev
