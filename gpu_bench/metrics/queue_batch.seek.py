"""Mean requests per batched tower pass (the batch queue's coalescing): the
count each of the program's ``queue.pass`` spans carries, inside the
measured window, passes overlapping the profiler's start and stop left out.
The program's own counterpart of ``tower_batch.seek``."""

from gpu_bench.harness import program_spans


def read(r):
    passes = program_spans.window_spans(r, "queue.pass")
    return sum(n for _, _, n in passes) / len(passes) if passes else None
