"""Median an /encryptedsearch request, over those wholly inside the
profiled slice, of the runtime and driver calls that enqueued a device
operation from inside the program's ``device program`` stage, on its
thread."""

from anns_bench import program_spans


def read(run):
    return program_spans.launches(run, "POST /encryptedsearch",
                                  "device program")
