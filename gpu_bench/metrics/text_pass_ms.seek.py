"""Mean host-clock time of a batched ``encode_text`` call (it ends in
``.cpu()``, so the device's time is in it), from the encoder proxy behind
the ``QueuedEncoder``; calls inside the profiled sub-window left out."""

from gpu_bench.harness.spans import outside_profile


def read(r):
    calls = outside_profile(r.driver.proxy_calls, r.trace)
    return 1e3 * sum(t1 - t0 for t0, t1, _ in calls) / len(calls) if calls else None
