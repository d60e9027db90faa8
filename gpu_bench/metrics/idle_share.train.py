"""The device's idle share of the profiled sub-window: 1 minus the union of
its kernel, copy and set intervals over the sub-window's length."""

from gpu_bench.harness import trace as tracing


def read(r):
    return 100.0 * (1.0 - tracing.busy_s(r.trace) / r.trace.window_s)
