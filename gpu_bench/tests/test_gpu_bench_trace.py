"""The traced run's record: the busy union, the idle share, and the refusal
of an incomplete record."""

import pytest

from gpu_bench.harness import trace as tracing


def _ev(cat, name, ts_us, dur_us, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events(missing=False):
    evs = [
        _ev("cuda_runtime", "cudaDeviceSynchronize", 0, 100),        # window opens at 100 us
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
        _ev("kernel", "tilemax_kernel<0, 1>", 120, 300, corr=1),     # 120-420
        _ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=2),
        _ev("kernel", "topk_merge_kernel", 400, 100, corr=2),        # 400-500: overlaps the first
        _ev("cuda_runtime", "cudaMemcpyAsync", 510, 5, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 600, 100, corr=3),          # 600-700
        _ev("cuda_runtime", "cudaStreamSynchronize", 515, 85),    # 515-600: the host waits
        _ev("kernel", "early", 50, 80, corr=9),                     # 50-130: clipped to 100-130
        _ev("cuda_runtime", "cudaDeviceSynchronize", 700, 300),      # window closes at 1000 us
        _ev("cuda_runtime", "cudaLaunchKernel", 1005, 5, corr=4),    # after the window: not checked
        _ev("cuda_runtime", "cudaLaunchKernel", 800, 5, corr=6),     # while the closing sync runs: not checked
    ]
    if missing:
        evs.append(_ev("cuda_runtime", "cudaLaunchKernel", 140, 5, corr=5))
    return evs


def test_busy_union_and_idle_share():
    tr = tracing.parse(_events())
    tracing.check_complete(tr)
    assert tr.window == pytest.approx((100e-6, 1000e-6))
    # 100-500 and 600-700 busy
    assert tracing.busy_s(tr) == pytest.approx(500e-6)
    assert 1 - tracing.busy_s(tr) / tr.window_s == pytest.approx(400 / 900)
    assert [k.name for k in tracing.kernels(tr, ("tilemax_kernel",))] == ["tilemax_kernel<0, 1>"]


def test_breakdown_names_ops_and_gaps():
    tr = tracing.parse(_events())
    b = tracing.breakdown(tr)
    assert b["device_ops"][0][0] == "tilemax_kernel<0, 1>"
    assert b["device_ops"][0][1] == pytest.approx(300e-6)
    labels = dict(b["idle_gaps"])
    # a gap is labelled by the runtime call open at its middle: 500-600 in the
    # stream synchronize, 700-1000 in the closing device synchronize
    assert labels["cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert labels["cudaDeviceSynchronize"] == pytest.approx(300e-6)


def test_batches_between_uploads():
    evs = _events() + [_ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t, 10, corr=20 + t)
                       for t in (150, 450, 800)]
    got = [t for pair in tracing.between_copies(tracing.parse(evs)) for t in pair]
    assert got == pytest.approx([150e-6, 450e-6, 450e-6, 800e-6])


def test_missing_device_record_fails():
    tr = tracing.parse(_events(missing=True))
    with pytest.raises(tracing.IncompleteTrace, match="1 of 4 launches"):
        tracing.check_complete(tr)


def test_a_record_without_bounds_fails():
    evs = [e for e in _events() if e["name"] != "cudaDeviceSynchronize"]
    with pytest.raises(tracing.IncompleteTrace):
        tracing.parse(evs)


def test_a_window_without_launches_fails():
    evs = [_ev("cuda_runtime", "cudaDeviceSynchronize", 0, 10), _ev("cuda_runtime", "cudaDeviceSynchronize", 50, 10)]
    with pytest.raises(tracing.IncompleteTrace):
        tracing.check_complete(tracing.parse(evs))


def test_sub_window_throws_away_an_incomplete_record(monkeypatch):
    """An incomplete record is thrown away and a fresh sub-window taken; the
    kept one is complete. Three incomplete ones in a row fail the run."""
    import json
    import time

    import torch
    import torch.profiler

    records = iter([_events(missing=True), _events(), _events(missing=True)] + [_events(missing=True)] * 3)

    class FakeProfile:
        def __init__(self, activities):
            self.events = next(records)

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": self.events}, f)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def run(attempts):
        sub = tracing.SubWindow(0.0, 0.0, attempts=attempts)
        sub.t_next = time.perf_counter()
        for _ in range(20):
            sub.tick()
            sub.t_next = min(sub.t_next, time.perf_counter())
        return sub

    sub = run(3)
    assert len(sub.failures) == 1 and sub.finish().window == pytest.approx((100e-6, 1000e-6))
    with pytest.raises(tracing.IncompleteTrace, match="no device record"):
        run(3).finish()
