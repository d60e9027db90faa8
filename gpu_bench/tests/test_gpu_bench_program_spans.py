"""The readers of the program's own spans: nothing from a program without the
recorder or without the spans (a parent checkout's program), hand-computed
values on a hand-built record whose fences put the trace's clock a known
offset from the host's, and the refusal of fences that disagree."""

from types import SimpleNamespace

import pytest

from clip_lora_match_tpu_torch.core import profiling
from gpu_bench.harness import program_spans
from gpu_bench.harness import trace as tracing
from gpu_bench.harness.manifest import Bench
from gpu_bench.harness.runner import Reading
from gpu_bench.tests.tiny import BENCH

SEEK = ("queue_wait_ms.seek", "queue_batch.seek", "tower_pass_ms.seek", "lock_wait_ms.seek",
        "lock_held_ms.seek", "idle_locked.seek", "idle_tower.seek")
TRAIN = ("optimizer_share.train", "backward_share.train", "launches_per_step.train")
HOST = ("queue_wait_ms.seek", "queue_batch.seek", "tower_pass_ms.seek", "lock_wait_ms.seek",
        "lock_held_ms.seek")

# the host's sub-window 10.0-11.0 s on time.perf_counter; the fences put the
# trace's clock 100.0 s and 100.0004 s ahead of it (the first read 0.4 ms
# late), so spans map at +100.0004
OFFSET = 100.0004


def _read(name, trace, t0=10.0, window_s=1.0):
    reader = Bench(BENCH.parent).metric_reader(name)
    return reader.read(Reading(None, SimpleNamespace(t0=t0), trace, window_s))


def _recorder(spans):
    rec = profiling.SpanRecorder()
    for name, t0, t1, n in spans:
        rec.record(name, round(t0 * 1e9), round(t1 * 1e9), n)
    return rec


def _trace(device=(), launches=(), last_fence=111.0004):
    tr = tracing.Trace((110.0, last_fence), list(device), list(launches), [], last_fence)
    tr.host_window = (10.0, 11.0)
    tr.overhead = (10.85, 10.86)
    return tr


SEEK_SPANS = [
    ("search.locked", 9.9, 10.05, None),     # opens before the window: clipped to it
    ("search.locked", 10.0, 10.2, None),
    ("search.locked", 10.4, 10.45, None),
    ("search.lock_wait", 10.38, 10.4, None),
    ("queue.pass", 10.15, 10.5, 3),
    ("queue.pass", 10.7, 10.8, 5),
    ("queue.wait", 10.01, 10.03, None),
    ("queue.wait", 10.851, 10.855, None),   # inside the profiler's start and stop: left out
    ("queue.wait", 10.6, 10.61, None),
    ("queue.wait", 10.99, 11.05, None),     # past the window's close: left out
]
SEEK_DEVICE = [tracing.Interval("tilemax_kernel<0, 1>", 110.1, 110.3, 1, "kernel"),
               tracing.Interval("gatherTopK", 110.5, 110.6, 2, "kernel")]


def _launch(t, corr):
    return tracing.Interval("cudaLaunchKernel", t, t + 1e-6, corr, "cuda_runtime")


TRAIN_SPANS = [
    ("train.step", 10.1, 10.3, None), ("train.backward", 10.15, 10.2, None),
    ("train.optimizer", 10.25, 10.3, None),
    ("train.step", 10.4, 10.6, None), ("train.backward", 10.45, 10.5, None),
    ("train.optimizer", 10.55, 10.6, None),
    ("train.step", 10.9, 11.2, None),        # not wholly in the sub-window: left out
]
# launch times on the trace's clock, correlation ids and device seconds
TRAIN_LAUNCHES = [(110.12, 1, 0.010), (110.17, 2, 0.020), (110.27, 3, 0.005),
                  (110.42, 4, 0.010), (110.47, 5, 0.015), (110.48, 6, 0.005), (110.57, 7, 0.005),
                  (110.95, 8, 0.100)]


def _train_trace(**kw):
    launches = [_launch(t, c) for t, c, _ in TRAIN_LAUNCHES]
    device = [tracing.Interval("k", t + 0.001, t + 0.001 + d, c, "kernel") for t, c, d in TRAIN_LAUNCHES]
    return _trace(device, launches, **kw)


@pytest.mark.parametrize("name", SEEK + TRAIN)
def test_nothing_without_the_recorder_or_its_spans(monkeypatch, name):
    trace = _train_trace() if name in TRAIN else _trace(SEEK_DEVICE)
    monkeypatch.delattr(profiling, "RECORDER")
    assert _read(name, trace) is None
    monkeypatch.setattr(profiling, "RECORDER", profiling.SpanRecorder(), raising=False)
    assert _read(name, trace) is None


def test_seek_readers_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", _recorder(SEEK_SPANS))
    tr = _trace(SEEK_DEVICE)
    assert program_spans.clock_offset(tr) == pytest.approx(OFFSET, abs=1e-9)
    assert _read("queue_wait_ms.seek", tr) == pytest.approx(15.0)
    assert _read("queue_batch.seek", tr) == pytest.approx(4.0)
    assert _read("tower_pass_ms.seek", tr) == pytest.approx(225.0)
    assert _read("lock_wait_ms.seek", tr) == pytest.approx(20.0)
    assert _read("lock_held_ms.seek", tr) == pytest.approx(125.0)
    # idle: 110.0-110.1, 110.3-110.5, 110.6-111.0004; the lock held over
    # 110.0-110.2004 and 110.4004-110.4504
    assert _read("idle_locked.seek", tr) == pytest.approx(100 * (0.1 + 0.05) / 1.0004, rel=1e-9)
    # passes 110.1504-110.5004 and 110.7004-110.8004, idle and the lock free
    # over 110.3-110.4004, 110.4504-110.5 and 110.7004-110.8004
    assert _read("idle_tower.seek", tr) == pytest.approx(100 * (0.1004 + 0.0496 + 0.1) / 1.0004, rel=1e-9)


def test_train_readers_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", _recorder(TRAIN_SPANS))
    tr = _train_trace()
    # two whole steps: launches 1-7, 0.070 s of device time; backward
    # launches 2, 5, 6 (0.040 s), optimizer 3, 7 (0.010 s)
    assert _read("backward_share.train", tr) == pytest.approx(100 * 0.040 / 0.070)
    assert _read("optimizer_share.train", tr) == pytest.approx(100 * 0.010 / 0.070)
    assert _read("launches_per_step.train", tr) == pytest.approx(3.5)


def test_the_fence_read_soonest_sets_the_offset():
    assert program_spans.clock_offset(_trace(last_fence=111.0004)) == pytest.approx(100.0004, abs=1e-9)
    assert program_spans.clock_offset(_trace(last_fence=110.9996)) == pytest.approx(100.0, abs=1e-9)
    assert program_spans.clock_offset(_trace(last_fence=111.0045)) == pytest.approx(100.0045, abs=1e-9)
    assert program_spans.clock_offset(_trace(last_fence=111.0140)) == pytest.approx(100.0140, abs=1e-9)


def test_fences_that_disagree_put_no_span_on_the_trace(monkeypatch, capsys):
    monkeypatch.setattr(profiling, "RECORDER", _recorder(SEEK_SPANS + TRAIN_SPANS))
    seek, train = _trace(SEEK_DEVICE, last_fence=111.0504), _train_trace(last_fence=111.0504)
    assert program_spans.clock_offset(seek) is None
    assert "50.400 ms apart (more than 50 ms)" in capsys.readouterr().err
    for name in SEEK + TRAIN:
        value = _read(name, train if name in TRAIN else seek)
        assert (value is not None) == (name in HOST), name


def test_the_offsets_go_to_stderr_once_a_trace(monkeypatch, capsys):
    monkeypatch.setattr(profiling, "RECORDER", _recorder(SEEK_SPANS))
    tr = _trace(SEEK_DEVICE)
    for name in SEEK:
        assert _read(name, tr) is not None
    err = capsys.readouterr().err
    assert err.count("fences put the trace's clock") == 1
    assert "100.000000 s and 100.000400 s from the host's, 0.400 ms apart\n" in err


def _dropping(first):
    """A recorder that held ``first`` and then ``SEEK_SPANS``, with room for
    all but its first record."""
    rec = profiling.SpanRecorder(capacity=len(first) + len(SEEK_SPANS) - 1)
    for name, t0, t1, n in first + SEEK_SPANS:
        rec.record(name, round(t0 * 1e9), round(t1 * 1e9), n)
    assert rec.dropped == 1
    return rec


def test_a_recorder_that_dropped_spans_of_the_window_gives_nothing(monkeypatch, capsys):
    monkeypatch.setattr(profiling, "RECORDER", _dropping([("queue.wait", 9.95, 9.96, None)]))
    for name in SEEK:
        assert _read(name, _trace(SEEK_DEVICE)) is None, name
    assert "span recorder dropped 1 spans" in capsys.readouterr().err


def test_spans_dropped_long_before_the_window_leave_it_whole(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", _dropping([("queue.wait", 5.0, 5.1, None),
                                                          ("queue.wait", 8.0, 8.5, None)]))
    assert _read("queue_wait_ms.seek", _trace(SEEK_DEVICE)) == pytest.approx(15.0)
    assert _read("idle_locked.seek", _trace(SEEK_DEVICE)) == pytest.approx(100 * 0.15 / 1.0004, rel=1e-9)
