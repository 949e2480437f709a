"""torch.cuda.max_memory_allocated from the end of the index build through
the window, in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
