"""The benchmark's own host-clock spans."""

from __future__ import annotations


def outside_profile(spans, trace):
    """The spans (tuples starting with t0, t1 on ``time.perf_counter``) that
    do not overlap the profiled sub-window with the profiler's own start and
    stop, whose overhead they would carry."""
    if trace is None:
        return list(spans)
    h0, h1 = trace.overhead
    return [s for s in spans if s[1] < h0 or s[0] > h1]
