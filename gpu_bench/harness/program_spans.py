"""The program's own spans, as the per-layer metrics read them: the port's
recorder (``clip_lora_match_tpu_torch.core.profiling.RECORDER``, spans on
``time.perf_counter_ns``), the measured window's spans for the host-clock
readers, and the traced sub-window's spans put on the device trace's clock.

A program without the recorder, or a run in which it recorded no span of a
name, gives nothing here, and the reader returns None: the metric is left
out of the line. Nothing here catches an exception.

The trace's clock: ``SubWindow`` fences the sub-window with two device
synchronizes; their records end at ``trace.window[0]`` and
``trace.window[1]``, and the host read ``trace.host_window`` on
``time.perf_counter`` after each returned. A host reading can only come
late: on an H100 the first fence's came back 0.1-13.6 ms after its record
ended (the synchronize's record lasting microseconds where the host's call
lasted milliseconds), the closing fence's within ~0.07 ms, and the closing
offset agreed across processes within 0.066 ms. So the larger of the two
offsets, the fence read soonest, maps a host time onto the trace's clock,
and is off by the smaller of the two delays, whatever the larger one was.
The two offsets go to standard error in every traced run that reads a
span. Fences that disagree by more than ``FENCE_AGREEMENT_S``, several
times the widest host delay seen, are taken for records that are not the
fences, and refuse the mapping, with the reason beside them.

A recorder that has dropped spans the window may have held gives no spans
for it either, with the reason on standard error: a mean over what
survived would read a part of the window as the whole.
"""

from __future__ import annotations

import sys

from gpu_bench.harness import trace as tracing
from gpu_bench.harness.spans import outside_profile

FENCE_AGREEMENT_S = 50e-3

_offsets: tuple = (None, None)  # (the last trace mapped, its offset)


def recorder():
    """The program's span recorder, or None where the program has none."""
    from clip_lora_match_tpu_torch.core import profiling

    return getattr(profiling, "RECORDER", None)


def held_spans(rec, name: str, t0: float, t1: float, whole: bool = True) -> list:
    """``rec.spans``, empty where the ring dropped spans the range may have
    held (said on standard error)."""
    spans = rec.spans(name, t0, t1, whole=whole)
    if spans is None:
        print(f"gpu_bench: the program's span recorder dropped {rec.dropped} spans, some of them "
              f"perhaps inside the window: no {name} span is read", file=sys.stderr)
        return []
    return spans


def window_spans(r, name: str) -> list[tuple[float, float, int | None]]:
    """``name``'s spans ``(t0, t1, n)``, seconds on ``time.perf_counter``,
    that lie inside the measured window and outside the profiler's own start
    and stop."""
    rec = recorder()
    if rec is None:
        return []
    t0 = r.driver.t0
    spans = [(s.t0_ns * 1e-9, s.t1_ns * 1e-9, s.n) for s in held_spans(rec, name, t0, t0 + r.window_s)]
    return outside_profile(spans, r.trace)


def mean_ms(r, name: str) -> float | None:
    """Mean length of ``name``'s window spans, in ms."""
    spans = window_spans(r, name)
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / len(spans) if spans else None


def clock_offset(trace: tracing.Trace) -> float | None:
    """Seconds that put a ``time.perf_counter`` time on the trace's clock:
    the larger of the two fences' offsets; None where they disagree by
    more than ``FENCE_AGREEMENT_S``. Both offsets go to standard error,
    once a trace."""
    global _offsets
    if _offsets[0] is trace:
        return _offsets[1]
    first, last = (w - h for w, h in zip(trace.window, trace.host_window))
    apart = abs(first - last)
    agreed = apart <= FENCE_AGREEMENT_S
    print(f"gpu_bench: the sub-window's fences put the trace's clock {first:.6f} s and {last:.6f} s "
          f"from the host's, {apart * 1e3:.3f} ms apart"
          + ("" if agreed else f" (more than {FENCE_AGREEMENT_S * 1e3:g} ms): no program span is put "
             "on the trace"), file=sys.stderr)
    _offsets = (trace, max(first, last) if agreed else None)
    return _offsets[1]


def trace_spans(r, name: str, whole: bool = True) -> list[tuple[float, float]]:
    """``name``'s spans on the trace's clock: those inside the traced
    sub-window, or with ``whole=False`` those that overlap it, clipped to
    it. Empty without the recorder, the spans, or an agreed mapping."""
    rec = recorder()
    if rec is None:
        return []
    h0, h1 = r.trace.host_window
    spans = held_spans(rec, name, h0, h1, whole=whole)
    if not spans:
        return []
    offset = clock_offset(r.trace)
    if offset is None:
        return []
    t0, t1 = r.trace.window
    mapped = [(max(s.t0_ns * 1e-9 + offset, t0), min(s.t1_ns * 1e-9 + offset, t1)) for s in spans]
    return [(s, e) for s, e in mapped if e >= s]


# -- sets of intervals: sorted, disjoint (s, e) lists -----------------------------


def intersect(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def length(a: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in a)


def idle_share_under(r, name: str, minus: str | None = None) -> float | None:
    """% of the sub-window in which the device is idle while some span of
    ``name`` is open and, with ``minus``, no span of ``minus`` is."""
    inside = tracing._union(trace_spans(r, name, whole=False))
    if not inside:
        return None
    idle = subtract([r.trace.window], tracing.busy_intervals(r.trace))
    if minus is not None:
        idle = subtract(idle, tracing._union(trace_spans(r, minus, whole=False)))
    return 100.0 * length(intersect(idle, inside)) / r.trace.window_s


def launches_inside(trace: tracing.Trace, spans: list[tuple[float, float]]) -> list[tracing.Interval]:
    """The launch records that start inside any of ``spans``."""
    return [l for l in trace.launches if any(s <= l.start <= e for s, e in spans)]


def device_s(trace: tracing.Trace, launches: list[tracing.Interval]) -> float:
    """Device time of the kernels and copies of ``launches``, matched by
    correlation id."""
    corr = {l.corr for l in launches if l.corr is not None}
    return sum(d.end - d.start for d in trace.device if d.corr in corr)


def step_share(r, phase: str) -> float | None:
    """% of the device time launched inside whole ``train.step`` spans of
    the sub-window that was launched inside their ``phase`` spans."""
    steps = trace_spans(r, "train.step")
    if not steps:
        return None
    phases = [(s, e) for s, e in trace_spans(r, phase) if any(a <= s and e <= b for a, b in steps)]
    total = device_s(r.trace, launches_inside(r.trace, steps))
    if not total > 0:
        return None
    return 100.0 * device_s(r.trace, launches_inside(r.trace, phases)) / total
