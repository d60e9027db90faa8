"""Mean time a search holds ``index.lock`` (the top-k's passes and its
readback): the program's ``search.locked`` spans inside the measured window,
those overlapping the profiler's start and stop left out."""

from gpu_bench.harness import program_spans


def read(r):
    return program_spans.mean_ms(r, "search.locked")
