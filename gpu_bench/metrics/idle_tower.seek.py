"""% of the profiled sub-window in which the device is idle, no search
holds ``index.lock``, and a batched tower pass is open: the device's idle
time inside the union of the program's ``queue.pass`` spans and outside that
of its ``search.locked`` spans, both put on the trace's clock. What
``idle_share.seek`` leaves beyond this and ``idle_locked.seek`` no program
span covers."""

from gpu_bench.harness import program_spans


def read(r):
    return program_spans.idle_share_under(r, "queue.pass", minus="search.locked")
