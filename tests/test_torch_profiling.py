"""The port's span recorder (``core/profiling.py``) and the spans that its
batch queue, search and train step record, on the CPU: the ring's bound and
drop count, thread ids, the off switch, the profiler range, and each site's
spans against what the site did."""

import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from clip_lora_match_tpu_torch.core import profiling as P
from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig, TrainingConfig
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
from clip_lora_match_tpu_torch.lora.adapter import init_lora
from clip_lora_match_tpu_torch.models.clip import init_params
from clip_lora_match_tpu_torch.retrieval.search import SearchIndex
from clip_lora_match_tpu_torch.services.batch_queue import EncoderBatchQueue
from clip_lora_match_tpu_torch.train import step as tstep

TINY = ClipArchConfig(image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=2,
                      vision_mlp_dim=128, text_width=64, text_layers=2, text_heads=2, text_mlp_dim=128,
                      vocab_size=514, projection_dim=32)
EOT = 513


def _recorded(fn, *names):
    """Run ``fn``; the global recorder's spans of each name during it."""
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    return out, {n: P.RECORDER.spans(n, t0, t1) for n in names}


def test_ring_keeps_the_newest_and_counts_what_it_drops():
    rec = P.SpanRecorder(capacity=4)
    for i in range(6):  # span i from i s to i + 0.5 s
        rec.record("x", 1_000_000_000 * i, 1_000_000_000 * i + 500_000_000, n=i)
    assert rec.recorded == 6 and rec.dropped == 2
    # the oldest held span (2) ended at 2.5 s, more than the margin before 3.6 s
    assert [s.n for s in rec.spans("x", 3.6, 10.0)] == [4, 5]
    assert rec.spans("x", 3.6, 4.2) == []
    assert [s.n for s in rec.spans("x", 3.6, 4.2, whole=False)] == [4]
    assert rec.spans("y", 3.6, 10.0) == []
    # the seek cell's longest window (~4 spans a request, ~5,700 requests
    # in 30 s) fits at least three times over
    assert P.RECORDER.capacity >= 3 * 4 * 5700


def test_a_read_the_dropped_spans_may_have_reached_gives_none():
    rec = P.SpanRecorder(capacity=4)
    for i in range(4):
        rec.record("x", 1_000_000_000 * i, 1_000_000_000 * i + 500_000_000, n=i)
    assert rec.dropped == 0 and len(rec.spans("x", 0.0, 10.0)) == 4
    rec.record("x", 4_000_000_000, 4_500_000_000, n=4)
    assert rec.dropped == 1
    # span 0 is gone: a range from before its end reads nothing rather than
    # a part, and so does one that starts within the margin of the oldest
    # held span's end (1.5 s)
    assert rec.spans("x", 0.0, 10.0) is None
    assert rec.spans("x", 2.4, 10.0) is None
    assert rec.spans("y", 2.4, 10.0) is None
    assert [s.n for s in rec.spans("x", 2.6, 10.0)] == [3, 4]


def test_spans_carry_their_threads_and_lie_inside_or_overlap_the_window():
    rec = P.SpanRecorder(capacity=2000)
    start = threading.Barrier(8)

    def work():
        start.wait(timeout=30)
        for _ in range(200):
            rec.record("t", 10, 20)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert rec.recorded == 1600 and rec.dropped == 0
    got = rec.spans("t", 0.0, 1.0)
    assert len(got) == 1600 and {s.tid for s in got} == {t.ident for t in threads}

    rec.record("w", 1_000_000_000, 2_000_000_000)
    assert rec.spans("w", 1.5, 3.0) == []
    assert len(rec.spans("w", 1.5, 3.0, whole=False)) == 1
    assert len(rec.spans("w", 0.5, 2.5)) == 1
    assert rec.spans("w", 2.5, 3.0, whole=False) == []


def test_annotate_records_on_the_calling_thread_until_switched_off():
    def body():
        with P.annotate("test.on", n=3):
            time.sleep(0.002)
        P.RECORDER.enabled = False
        try:
            with P.annotate("test.off"):
                pass
        finally:
            P.RECORDER.enabled = True

    _, got = _recorded(body, "test.on", "test.off")
    (on,) = got["test.on"]
    assert on.n == 3 and on.tid == threading.get_ident() and on.t1_ns - on.t0_ns >= 2_000_000
    assert got["test.off"] == []


def test_annotate_writes_its_range_into_a_running_profilers_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()

    def body():
        with P.annotate("test.profiled", n=1):
            torch.ones(32, 32) @ torch.ones(32, 32)
        P.RECORDER.enabled = False
        try:
            with P.annotate("test.profiled_off"):
                torch.ones(32, 32) @ torch.ones(32, 32)
        finally:
            P.RECORDER.enabled = True

    try:
        _, got = _recorded(body, "test.profiled", "test.profiled_off")
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "test.profiled" and e.get("ph") == "X" for e in events)
    assert len(got["test.profiled"]) == 1
    # switched off, a span is not even a range in the profiler's trace
    assert not any(e.get("name") == "test.profiled_off" for e in events)
    assert got["test.profiled_off"] == []


class _FakeEncoder:
    def __init__(self):
        self.sizes: list[int] = []

    def encode_text(self, texts, normalize=True):
        self.sizes.append(len(texts))
        time.sleep(0.01)
        return np.ones((len(texts), 4), np.float32)


def test_batch_queue_records_each_wait_and_each_pass_with_its_size():
    enc = _FakeEncoder()
    q = EncoderBatchQueue(enc, max_batch=8, linger_ms=20.0)

    def serve():
        with ThreadPoolExecutor(20) as pool:
            return list(pool.map(q.encode_text, [f"text {i}" for i in range(20)]))

    try:
        out, got = _recorded(serve, "queue.wait", "queue.pass")
    finally:
        q.close()
    assert len(out) == 20
    waits, passes = got["queue.wait"], got["queue.pass"]
    assert [p.n for p in passes] == enc.sizes and sum(enc.sizes) == 20
    assert len(waits) == 20
    assert {s.tid for s in waits + passes} == {q._worker.ident}
    # each wait ends where its pass begins: the waits that end together are
    # one pass's requests
    ends = sorted({w.t1_ns for w in waits})
    assert [sum(w.t1_ns == e for w in waits) for e in ends] == enc.sizes
    for e, p in zip(ends, passes):
        assert e <= p.t0_ns < e + 5_000_000
    assert all(w.t0_ns <= w.t1_ns for w in waits)


@pytest.mark.parametrize("method", ["search_with_embedding", "search_batch"])
def test_search_records_the_lock_wait_and_the_hold(method):
    rows = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    search = SearchIndex(EmbeddingIndex(rows, device="cpu"), dim=8, device="cpu")
    query = rows[3] if method == "search_with_embedding" else rows[3:6]
    call = lambda: getattr(search, method)(query, k=4)  # noqa: E731
    alone = call()
    held, release = threading.Event(), threading.Event()

    def holder():
        with search.index.lock:
            held.set()
            release.wait(timeout=30)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(timeout=30)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    try:
        out, got = _recorded(call, "search.lock_wait", "search.locked")
    finally:
        release.set()
        t.join(timeout=30)
    assert not t.is_alive()
    lists = lambda res: [res] if method == "search_with_embedding" else res  # noqa: E731
    assert [[r.index for r in rs] for rs in lists(out)] == [[r.index for r in rs] for rs in lists(alone)]
    (wait,), (locked,) = got["search.lock_wait"], got["search.locked"]
    assert wait.t1_ns - wait.t0_ns >= 150_000_000  # the other thread kept the lock ~0.2 s
    assert wait.t1_ns <= locked.t0_ns <= locked.t1_ns
    assert locked.t1_ns - locked.t0_ns < wait.t1_ns - wait.t0_ns
    assert wait.tid == locked.tid == threading.get_ident()


def test_train_step_spans_nest_inside_the_step():
    lora_cfg = LoraConfig(r=4, alpha=8, dropout=0.0)
    train_cfg = TrainingConfig(batch_size=4, learning_rate=1e-3, warmup_ratio=0.0)
    params = init_params(0, TINY, device="cpu")
    tx, _ = tstep.make_optimizer(train_cfg, 10)
    state = tstep.init_train_state(init_lora(1, TINY, lora_cfg, device="cpu"), tx, seed=0)
    step = tstep.make_train_step(params, TINY, lora_cfg, train_cfg, tx, eot_id=EOT)
    rng = np.random.default_rng(2)
    ids = np.full((4, 77), EOT, np.int32)
    ids[:, :6] = rng.integers(1, 500, (4, 6))
    mask = np.zeros((4, 77), np.int32)
    mask[:, :7] = 1
    batch = {"pixel_values": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8), "input_ids": ids,
             "attention_mask": mask}

    def two_steps():
        s = state
        for _ in range(2):
            s, m = step(s, batch)
        return s, m

    (_, m), got = _recorded(two_steps, "train.step", "train.backward", "train.optimizer")
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    steps, backs, opts = got["train.step"], got["train.backward"], got["train.optimizer"]
    assert len(steps) == len(backs) == len(opts) == 2
    for s, b, o in zip(steps, backs, opts):
        assert s.t0_ns <= b.t0_ns <= b.t1_ns <= o.t0_ns <= o.t1_ns <= s.t1_ns
