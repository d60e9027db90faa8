"""Mean time a search waits for ``index.lock``: the program's
``search.lock_wait`` spans inside the measured window, those overlapping the
profiler's start and stop left out."""

from gpu_bench.harness import program_spans


def read(r):
    return program_spans.mean_ms(r, "search.lock_wait")
