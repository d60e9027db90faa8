"""Share of its roofline of pass 1 of the two-pass exact top-k over the fp32
index (``tilemax_sup``, the ``tilemax_kernel`` / ``tilemax_mma_kernel``
launches of the profiled sub-window): each launch's least time (the index,
the query and the tile and group maxima at the published HBM rate, or its
fp32 products at the fp32 peak, whichever is larger; ``counts/kernels.py``)
over the launches' device time. Every launch in a seek cell is one query
over the whole index."""

from gpu_bench.counts.kernels import tilemax_sup_bound_s
from gpu_bench.harness import trace as tracing


def read(r):
    launches = tracing.kernels(r.trace, ("tilemax_kernel", "tilemax_mma_kernel"))
    if not launches:
        return None
    bound = tilemax_sup_bound_s(1, r.driver.N, r.driver.D)
    return 100.0 * bound * len(launches) / sum(k.end - k.start for k in launches)
