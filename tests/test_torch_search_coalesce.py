"""``SearchIndex.search_with_embedding`` callers that queue behind
``index.lock`` share passes: one ``_topk`` pass per distinct ``k`` of at most
``PASS_QUERIES`` queries, recorded as one ``search.locked`` span carrying its
query count, each caller's result equal to its lone call (ids exact, scores
within 1e-6), a pass's exception raised by each of its callers, and a lone
caller's one-query pass as before."""

import sys
import threading
import time

import numpy as np
import pytest

from clip_lora_match_tpu_torch.core import profiling as P
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
from clip_lora_match_tpu_torch.retrieval import search as S
from clip_lora_match_tpu_torch.retrieval.search import SearchIndex

D = 32
ROUTES = {"plain": {}, "int8": {"quantize": "int8"}, "approximate": {"approximate": True}}


def _search(route="plain", rows=512):
    emb = np.random.default_rng(0).normal(size=(rows, D)).astype(np.float32)
    return SearchIndex(EmbeddingIndex(emb, device="cpu"), dim=D, device="cpu", **ROUTES[route])


def _queries(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _pairs(res):
    return [r.index for r in res], np.array([r.score for r in res])


def _assert_same(got, lone):
    (gi, gs), (li, ls) = _pairs(got), _pairs(lone)
    assert gi == li
    np.testing.assert_allclose(gs, ls, rtol=0, atol=1e-6)


def _queued(search, calls):
    """Run ``calls`` (query, k) on a thread each while another thread holds
    ``index.lock``; release it once all are queued. → (results in the order
    of ``calls``, the ``search.locked`` spans recorded meanwhile)."""
    out = [None] * len(calls)
    held, release = threading.Event(), threading.Event()

    def holder():
        with search.index.lock:
            held.set()
            release.wait(timeout=30)

    def caller(j, q, k):
        try:
            out[j] = search.search_with_embedding(q, k)
        except Exception as e:  # noqa: BLE001 - the test reads what each caller got
            out[j] = e

    t0 = time.perf_counter()
    h = threading.Thread(target=holder)
    h.start()
    assert held.wait(timeout=30)
    callers = [threading.Thread(target=caller, args=(j, q, k)) for j, (q, k) in enumerate(calls)]
    try:
        for t in callers:
            t.start()
        deadline = time.monotonic() + 30
        while len(search._pending) < len(calls) and time.monotonic() < deadline:
            time.sleep(0.001)
        assert len(search._pending) == len(calls)
    finally:
        release.set()
        h.join(timeout=30)
        for t in callers:
            t.join(timeout=30)
    assert not h.is_alive() and not any(t.is_alive() for t in callers)
    return out, P.RECORDER.spans("search.locked", t0, time.perf_counter())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_queued_callers_share_one_pass_equal_to_their_lone_calls(route):
    search = _search(route)
    qs = _queries(12)
    lone = [search.search_with_embedding(q, 5) for q in qs]
    got, passes = _queued(search, [(q, 5) for q in qs])
    assert [p.n for p in passes] == [12]
    for g, a in zip(got, lone):
        _assert_same(g, a)


def test_each_k_gets_its_own_pass():
    search = _search()
    qs = _queries(9)
    ks = [3, 7, 3, 3, 7, 3, 7, 3, 3]
    lone = [search.search_with_embedding(q, k) for q, k in zip(qs, ks)]
    got, passes = _queued(search, list(zip(qs, ks)))
    assert sorted(p.n for p in passes) == [3, 6]
    for g, a, k in zip(got, lone, ks):
        assert len(g) == k
        _assert_same(g, a)


def test_a_pass_takes_at_most_pass_queries(monkeypatch):
    monkeypatch.setattr(S, "PASS_QUERIES", 3)
    search = _search()
    qs = _queries(7)
    lone = [search.search_with_embedding(q, 4) for q in qs]
    got, passes = _queued(search, [(q, 4) for q in qs])
    assert [p.n for p in passes] == [3, 3, 1]
    for g, a in zip(got, lone):
        _assert_same(g, a)


def test_a_pass_that_raises_raises_in_each_of_its_callers(monkeypatch):
    search = _search()
    qs = _queries(5)
    lone = search.search_with_embedding(qs[0], 5)
    topk, failed = search._topk, []

    def once(queries, k):
        if not failed:
            failed.append(len(queries))
            raise RuntimeError("planted")
        return topk(queries, k)

    monkeypatch.setattr(search, "_topk", once)
    got, passes = _queued(search, [(q, 5) for q in qs])
    assert failed == [5] and [p.n for p in passes] == [5]
    assert all(isinstance(g, RuntimeError) and str(g) == "planted" for g in got)
    _assert_same(search.search_with_embedding(qs[0], 5), lone)  # the next call is served


def test_a_lone_caller_runs_one_pass_of_one_query(monkeypatch):
    search = _search()
    q = _queries(1)[0]
    seen = []
    topk = search._topk
    monkeypatch.setattr(search, "_topk", lambda queries, k: seen.append(queries.shape) or topk(queries, k))
    t0 = time.perf_counter()
    res = search.search_with_embedding(q[None], 5)
    passes = P.RECORDER.spans("search.locked", t0, time.perf_counter())
    assert seen == [(1, D)] and [p.n for p in passes] == [1]
    assert passes[0].tid == threading.get_ident()
    scores, ids = search._topk(q[None], 5)
    assert [r.index for r in res] == ids[0].tolist() and [r.score for r in res] == scores[0].tolist()


def test_callers_served_by_another_pass_record_no_pass():
    search = _search()
    qs = _queries(6)
    t0 = time.perf_counter()
    _, passes = _queued(search, [(q, 5) for q in qs])
    waits = P.RECORDER.spans("search.lock_wait", t0, time.perf_counter())
    assert len(passes) == 1 and len(waits) == 6
    assert passes[0].tid in {w.tid for w in waits}


def test_many_threads_each_query_served_once_and_right():
    """Sixteen threads, more than the cores here, searching in a loop under
    a short switch interval: each result equals its lone call, and the
    passes' counts add up to the calls."""
    search = _search(rows=2048)
    qs = _queries(64, seed=3)
    ks = [3 + (i % 2) * 2 for i in range(64)]
    lone = [_pairs(search.search_with_embedding(q, k)) for q, k in zip(qs, ks)]
    errors, calls = [], 16 * 12

    def worker(w):
        for j in range(12):
            i = (w * 12 + j) % 64
            try:
                got = _pairs(search.search_with_embedding(qs[i], ks[i]))
                assert got[0] == lone[i][0]
                np.testing.assert_allclose(got[1], lone[i][1], rtol=0, atol=1e-6)
            except Exception as e:  # noqa: BLE001 - gathered and asserted below
                errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    passes = P.RECORDER.spans("search.locked", t0, time.perf_counter())
    assert sum(p.n for p in passes) == calls and not search._pending
