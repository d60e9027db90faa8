"""Mean queries a top-k pass serves (the search's sharing of one pass among
the seekers queued on ``index.lock``): the count each of the program's
``search.locked`` spans carries, inside the measured window, passes
overlapping the profiler's start and stop left out. Nothing where no such
span carries a count (a program whose passes are not shared)."""

from gpu_bench.harness import program_spans


def read(r):
    counts = [n for _, _, n in program_spans.window_spans(r, "search.locked") if n is not None]
    return sum(counts) / len(counts) if counts else None
