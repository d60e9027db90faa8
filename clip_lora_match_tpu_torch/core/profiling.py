"""Tracing and timing hooks (port of ``core/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` capture of the body (CPU, and the
  card's kernels where CUDA is available), written into ``log_dir`` as a
  Chrome trace (``chrome://tracing`` or Perfetto);
- ``annotate(name)``: a named range, a ``record_function`` span in that
  trace plus an NVTX range where CUDA is available;
- ``StepTimer``: rolling wall times of a repeated operation with the JAX
  package's ``summary()`` keys (``avg_query_time_ms``, p50, p95, max).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body; the trace lands in ``log_dir/trace_<pid>_<ms>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns() // 1_000_000}.json")
    )


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span in the profiler's timeline (and an NVTX range on CUDA)."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Rolling wall-clock stats for a repeated operation."""

    def __init__(self, window: int = 1000):
        self._times: deque[float] = deque(maxlen=window)
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        assert self._t0 is not None
        self._times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def count(self) -> int:
        return len(self._times)

    def summary(self) -> dict:
        if not self._times:
            return {"count": 0}
        arr = np.asarray(self._times) * 1e3
        return {
            "count": len(arr),
            "avg_query_time_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "max_ms": float(arr.max()),
        }
