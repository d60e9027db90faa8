"""The traced run's device record: a ``torch.profiler`` capture of the CUDA
activity (kernels, copies and the host's runtime calls; no CPU operator
events, whose recording would slow the host that paces these cells) over a
short steady sub-window a few seconds into the measured window, read back
from its Chrome trace.

The sub-window is fenced by two ``torch.cuda.synchronize()`` calls, whose
runtime records give its bounds on the trace's clock. Every launch and copy
that returned before the closing synchronize began has to have its device
record, matched by correlation id: the profiler has been seen to lose device
records late in long runs, and an idle share read from an incomplete record
would be wrong. So a missing record raises ``IncompleteTrace`` and the run
prints no result.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_NAMES = ("cudaDeviceSynchronize",)
# host calls that put work on the device and so must have a device record
LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "Memcpy", "Memset")


class IncompleteTrace(RuntimeError):
    """The profiler's record lacks device work that the host issued."""


@dataclass
class Interval:
    name: str
    start: float  # seconds on the trace's clock
    end: float
    corr: int | None = None
    cat: str = ""


@dataclass
class Trace:
    window: tuple[float, float]
    device: list[Interval] = field(default_factory=list)
    launches: list[Interval] = field(default_factory=list)
    runtime: list[Interval] = field(default_factory=list)
    closing_sync_start: float = 0.0
    host_window: tuple[float, float] = (0.0, 0.0)  # perf_counter seconds
    overhead: tuple[float, float] = (0.0, 0.0)  # the profiler's start and stop included

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _corr(ev: dict):
    args = ev.get("args") or {}
    c = args.get("correlation", args.get("correlation id"))
    return None if c is None else int(c)


def parse(events: list[dict]) -> Trace:
    """A Trace from Chrome-trace events (``traceEvents``): the window is
    from the end of the first synchronize record to the end of the last."""
    syncs, device, launches, runtime = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        start = float(ev["ts"]) * 1e-6
        iv = Interval(name, start, start + float(ev["dur"]) * 1e-6, _corr(ev), cat)
        if cat in DEVICE_CATS:
            device.append(iv)
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append(iv)
            if name in SYNC_NAMES:
                syncs.append(iv)
            elif any(w in name for w in LAUNCH_WORDS):
                launches.append(iv)
    if len(syncs) < 2:
        raise IncompleteTrace(f"{len(syncs)} synchronize records: the sub-window has no bounds")
    syncs.sort(key=lambda i: i.end)
    return Trace((syncs[0].end, syncs[-1].end), device, launches, runtime, syncs[-1].start)


def check_complete(trace: Trace) -> None:
    """Raise unless every launch inside the window that returned before the
    closing synchronize began has a device record (a launch from another
    thread while that synchronize runs may reach the card after it)."""
    t0 = trace.window[0]
    have = {d.corr for d in trace.device if d.corr is not None}
    inside = [l for l in trace.launches if l.start >= t0 and l.end <= trace.closing_sync_start]
    missing = [l for l in inside if l.corr is None or l.corr not in have]
    if not inside:
        raise IncompleteTrace("no launch recorded inside the sub-window")
    if missing:
        names = sorted({l.name for l in missing})
        raise IncompleteTrace(f"{len(missing)} of {len(inside)} launches in the sub-window have no "
                              f"device record ({', '.join(names)})")


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_intervals(trace: Trace) -> list[tuple[float, float]]:
    """The union of kernel, copy and set intervals, clipped to the window."""
    t0, t1 = trace.window
    clipped = [(max(d.start, t0), min(d.end, t1)) for d in trace.device]
    return _union([(s, e) for s, e in clipped if e > s])


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def kernels(trace: Trace, words: tuple[str, ...], exclude: tuple[str, ...] = ()) -> list[Interval]:
    """Kernels inside the window whose name holds any of ``words`` and none
    of ``exclude``."""
    t0, t1 = trace.window
    return [d for d in trace.device if d.cat == "kernel" and t0 <= d.start and d.end <= t1
            and any(w in d.name for w in words) and not any(x in d.name for x in exclude)]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing during each gap: the runtime call open at the gap's
    middle, or the last one that ended before it ("after <call>")."""
    t0, t1 = trace.window
    by_name: dict[str, float] = {}
    for d in trace.device:
        s, e = max(d.start, t0), min(d.end, t1)
        if e > s:
            by_name[d.name[:160]] = by_name.get(d.name[:160], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace)
    gaps, last = [], t0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    calls = sorted(trace.runtime, key=lambda c: c.start)
    starts = [c.start for c in calls]
    idle: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        open_ = [c for c in calls[max(0, i - 64):i] if c.end >= mid]
        if open_:
            label = max(open_, key=lambda c: c.start).name
        else:
            before = [c for c in calls[max(0, i - 64):i] if c.end < mid]
            label = f"after {max(before, key=lambda c: c.end).name}" if before else "no runtime call"
        idle[label] = idle.get(label, 0.0) + (e - s)
    gap_rows = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gap_rows]}


def between_copies(trace: Trace, name_word: str = "HtoD") -> list[tuple[float, float]]:
    """The device intervals from one host-to-device copy's start to the
    next's, inside the window: one unit of work each where every unit begins
    with one upload."""
    t0, t1 = trace.window
    starts = sorted(d.start for d in trace.device
                    if d.cat == "gpu_memcpy" and name_word in d.name and t0 <= d.start <= t1)
    return list(zip(starts, starts[1:]))


class SubWindow:
    """Starts the profiler ``start_after`` seconds into the window and stops
    it ``seconds`` later; the driver calls ``tick()`` between units of work.
    At the stop the record is read and checked: an incomplete one is
    reported on standard error, thrown away, and a fresh sub-window starts
    a second later, ``attempts`` in all. ``host_window`` is the kept
    sub-window on the host clock; ``overhead`` spans every attempt with the
    profiler's own start, stop and reading, which the host-clock per-layer
    metrics leave out."""

    def __init__(self, start_after: float, seconds: float, attempts: int = 3):
        self.start_after, self.seconds, self.attempts = start_after, seconds, attempts
        self.t_next = None
        self.prof = None
        self.done = False
        self.trace: Trace | None = None
        self.failures: list[str] = []
        self.host_window = (0.0, 0.0)
        self.overhead = (0.0, 0.0)

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracing, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()

    def begin(self, t_window: float) -> None:
        self.t_next = t_window + self.start_after

    def tick(self) -> None:
        if self.done or self.t_next is None:
            return
        now = time.perf_counter()
        if self.prof is None and now >= self.t_next:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if not self.failures:
                self.overhead = (now, now)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize()
            self._h0 = time.perf_counter()
        elif self.prof is not None and now - self._h0 >= self.seconds:
            self._stop()

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        h1 = time.perf_counter()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        try:
            trace = parse(events)
            check_complete(trace)
        except IncompleteTrace as e:
            self.failures.append(str(e))
            print(f"gpu_bench: profiled sub-window {len(self.failures)} thrown away: {e}", file=sys.stderr,
                  flush=True)
            self.done = len(self.failures) >= self.attempts
            self.t_next = time.perf_counter() + 1.0
        else:
            trace.host_window = self.host_window = (self._h0, h1)
            self.trace = trace
            self.done = True
        self.overhead = (self.overhead[0], time.perf_counter())

    def finish(self) -> Trace:
        """The checked trace; raise if no sub-window gave a complete record
        before the window closed."""
        if self.prof is not None:
            self._stop()
        if self.trace is None:
            raise IncompleteTrace("; ".join(self.failures) or "the window closed before the profiled "
                                  "sub-window began")
        self.trace.overhead = self.overhead
        return self.trace
