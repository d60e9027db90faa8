"""Tracing and timing hooks (port of ``core/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` capture of the body (CPU, and the
  card's kernels where CUDA is available), written into ``log_dir`` as a
  Chrome trace (``chrome://tracing`` or Perfetto);
- ``annotate(name, n=None)``: the port's one span primitive. The span is
  timed on ``time.perf_counter_ns`` (the clock of ``time.perf_counter``)
  and appended to ``RECORDER``; while a torch profiler runs it is also a
  ``record_function`` range in that profiler's trace, otherwise, where
  CUDA is available, an NVTX range;
- ``RECORDER``: the process-wide bounded ring of spans, on by default
  (``RECORDER.enabled = False`` turns every span off). The port records:

  | span | site | covers |
  |---|---|---|
  | ``queue.wait`` | ``services/batch_queue.py`` | one request, from its submission to the start of the tower pass that serves it |
  | ``queue.pass`` | the same | one tower pass over a drained batch, ``n`` its requests |
  | ``search.lock_wait`` | ``retrieval/search.py`` | acquiring ``index.lock`` |
  | ``search.locked`` | the same | one pass with ``index.lock`` held: the top-k and its readback, ``n`` its queries (none for ``search_batch``) |
  | ``train.step`` | ``train/step.py`` | one optimizer step |
  | ``train.backward`` | the same | ``torch.autograd.grad`` and the reduction over ranks |
  | ``train.optimizer`` | the same | the optimizer's update, its application and the ``grad_norm`` metric |
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Iterator, NamedTuple, Optional

import torch

# the seek path records ~4 spans a request: at ~200 requests/s a 30 s window
# fits ~5 times over
RING_CAPACITY = 1 << 17
# a record is appended after its span ends, and the ring drops in the order
# of appending: every dropped span ended before the oldest held one was
# appended, which a thread switch can delay by milliseconds
DROP_MARGIN_NS = 1_000_000_000

_now = time.perf_counter_ns
_get_ident = threading.get_ident
_profiler_on = torch._C._autograd._profiler_enabled
_nvtx: Optional[bool] = None  # whether CUDA is available, read at the first span


class Span(NamedTuple):
    name: str
    tid: int  # threading.get_ident() of the recording thread
    t0_ns: int  # time.perf_counter_ns()
    t1_ns: int
    n: Optional[int]


class SpanRecorder:
    """A bounded ring of spans ``(name, thread id, t0_ns, t1_ns, n)``: once
    ``capacity`` are held each new one drops the oldest, counted in
    ``dropped``. Writers take no lock: a deque's append and copy are each
    one step under the interpreter lock, and each record carries a sequence
    number from one counter, whose largest held value counts the records.
    A read over a range that dropped records may have reached gives None,
    not a part of the range."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self.enabled = True
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    @property
    def recorded(self) -> int:
        held = self._ring.copy()
        return max(r[5] for r in held) + 1 if held else 0

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - self.capacity)

    def record(self, name: str, t0_ns: int, t1_ns: int, n: Optional[int] = None) -> None:
        """Append one span, taken by the calling thread."""
        if self.enabled:
            self._ring.append((name, _get_ident(), t0_ns, t1_ns, n, next(self._seq)))

    def spans(self, name: str, t0: float, t1: float, whole: bool = True) -> Optional[list[Span]]:
        """The held spans of ``name`` that lie inside ``[t0, t1]``, seconds
        on ``time.perf_counter``, oldest first; ``whole=False``: those that
        overlap it. None where the ring has dropped records and the oldest
        it holds ended less than ``DROP_MARGIN_NS`` before ``t0``: a dropped
        span may then have lain in the range."""
        lo, hi = t0 * 1e9, t1 * 1e9
        held = self._ring.copy()
        if held and held[0][3] > lo - DROP_MARGIN_NS and self.dropped:
            return None
        if whole:
            return [Span._make(r[:5]) for r in held if r[0] == name and lo <= r[2] and r[3] <= hi]
        return [Span._make(r[:5]) for r in held if r[0] == name and r[3] >= lo and r[2] <= hi]


RECORDER = SpanRecorder()


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


class annotate:
    """A named span of the body, recorded in ``RECORDER`` with the optional
    count ``n``. While a torch profiler runs it is a ``record_function``
    range in that profiler's trace; otherwise, where CUDA is available, an
    NVTX range for Nsight. NVTX ranges are kept out of the profiler's CUPTI
    session: traced seek windows on an H100 that had them lost more device
    records. With ``RECORDER.enabled`` false at entry the span is none of
    these. A class rather than a generator, so that a span costs one to
    two microseconds."""

    __slots__ = ("name", "n", "_t0", "_range")

    def __init__(self, name: str, n: Optional[int] = None):
        self.name, self.n = name, n

    def __enter__(self) -> "annotate":
        global _nvtx
        if not RECORDER.enabled:
            self._t0 = None
            return self
        if _nvtx is None:
            _nvtx = torch.cuda.is_available()
        if _profiler_on():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
            if _nvtx:
                torch.cuda.nvtx.range_push(self.name)
        self._t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is None:
            return
        RECORDER.record(self.name, self._t0, _now(), self.n)
        if self._range is not None:
            self._range.__exit__(*exc)
        elif _nvtx:
            torch.cuda.nvtx.range_pop()
