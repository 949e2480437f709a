"""The device's idle share over a steady slice of the traced window:
1 − (union of kernel, copy and set intervals) / slice, from torch.profiler.
A slice that captured no device operation, or none of a stage that
always launches some (span_device.captured: the profiler lost the
device's records), reads nothing, never 100%. Where the program recorded
its spans, the slice's idle ms by innermost open span go to
.scratch/idle_by_span.<cell>.json (program_spans.attribution)."""

from anns_bench import program_spans, span_device

CELL = "sift1m-pir.fetch-100"


def read(run):
    d = run.device
    if not d or d["window_s"] <= 0 or d["busy_s"] <= 0 \
            or not span_device.captured(run):
        return None
    prog = program_spans.load(run)
    if prog is not None and prog.slice is not None \
            and prog.slice.h is not None:
        program_spans.write_attribution(program_spans.attribution(prog),
                                        CELL)
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
