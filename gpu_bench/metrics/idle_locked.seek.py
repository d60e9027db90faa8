"""% of the profiled sub-window in which the device is idle (no kernel, copy
or set) while some search holds ``index.lock``: the complement of the
device's busy union, intersected with the union of the program's
``search.locked`` spans put on the trace's clock."""

from gpu_bench.harness import program_spans


def read(r):
    return program_spans.idle_share_under(r, "search.locked")
