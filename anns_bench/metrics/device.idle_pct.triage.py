"""The device's idle share over a steady slice of the traced window:
1 − (union of kernel, copy and set intervals) / slice, from torch.profiler.
A slice that captured no device operation reads nothing, never 100%."""


def read(run):
    d = run.device
    if not d or d["window_s"] <= 0 or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
