"""Kernel launches, copies and sets a training step issues: the launch
records that start inside the program's ``train.step`` spans lying wholly in
the profiled sub-window (spans put on the trace's clock), per step."""

from gpu_bench.harness import program_spans


def read(r):
    steps = program_spans.trace_spans(r, "train.step")
    return len(program_spans.launches_inside(r.trace, steps)) / len(steps) if steps else None
