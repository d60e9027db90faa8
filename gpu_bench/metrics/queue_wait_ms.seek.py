"""Mean time a request waits in the batch queue, from its submission to the
start of the tower pass that serves it: the program's ``queue.wait`` spans
inside the measured window, those overlapping the profiler's start and stop
left out."""

from gpu_bench.harness import program_spans


def read(r):
    return program_spans.mean_ms(r, "queue.wait")
