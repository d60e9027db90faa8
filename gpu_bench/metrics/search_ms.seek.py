"""Mean host-clock time of ``SearchIndex.search_with_embedding`` (it ends in
``.cpu()``), from the benchmark's wrapper around it; calls inside the
profiled sub-window left out."""

from gpu_bench.harness.spans import outside_profile


def read(r):
    spans = outside_profile(r.driver.search_spans, r.trace)
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / len(spans) if spans else None
