"""The NTT entry points' share of their byte bound (roofline.ntt_work:
input, output and tables once) over the device time of the kernels
launched inside each ntt4/intt4 call the HE program made, summed over the
kept calls of the window, replayed under torch.profiler."""


def read(run):
    calls = (run.replay or {}).get("ntt") or []
    dev = sum(c[1] for c in calls)
    if dev <= 0:
        return None
    return 100.0 * sum(c[0] for c in calls) / dev
