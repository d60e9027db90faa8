"""The optimizer's share of a training step's device time: the device time
of the kernels and copies whose launch (matched by correlation id) starts
inside one of the program's ``train.optimizer`` spans, over that of the
launches inside its ``train.step`` spans, counting only steps that lie
wholly in the profiled sub-window; spans put on the trace's clock."""

from gpu_bench.harness import program_spans


def read(r):
    return program_spans.step_share(r, "train.optimizer")
