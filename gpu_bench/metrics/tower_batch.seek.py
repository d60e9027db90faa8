"""Mean requests per batched text-tower pass (the batch queue's coalescing),
counted by the encoder proxy behind the ``QueuedEncoder``; passes inside the
profiled sub-window left out."""

from gpu_bench.harness.spans import outside_profile


def read(r):
    calls = outside_profile(r.driver.proxy_calls, r.trace)
    return sum(n for _, _, n in calls) / len(calls) if calls else None
