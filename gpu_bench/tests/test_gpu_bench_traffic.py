"""The seeded traffic: it repeats for a seed, and every seed gets the same
work in another order; percentiles over all requests, failures infinitely
late."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from gpu_bench.harness import seeds, traffic
from gpu_bench.harness.stats import percentile
from gpu_bench.reference.tokenizer import ByteTokenizer

WORDS = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "lost_found_words.json").read_text())
BIG = 2 ** 33 + 12345


def test_arrivals_repeat_and_keep_their_gaps():
    a = traffic.arrival_offsets(500, 250.0, 2.0, BIG)
    b = traffic.arrival_offsets(500, 250.0, 2.0, BIG)
    c = traffic.arrival_offsets(500, 250.0, 2.0, BIG + 1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == 500 and np.all(np.diff(a) > 0) and 0 < a[0] and a[-1] < 2.0
    # the same gaps in another order
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(c, prepend=0)))
    assert abs(a[-1] - 2.0 * 499.5 / 500) < 1e-9


def test_lengths_and_texts_repeat_with_exact_token_counts():
    n1 = traffic.token_lengths(330, 8, 40, BIG)
    n2 = traffic.token_lengths(330, 8, 40, BIG + 7)
    assert sorted(n1) == sorted(n2) and not np.array_equal(n1, n2)
    assert n1.min() == 8 and n1.max() == 40
    t1 = traffic.texts(WORDS, n1, BIG, "queries")
    assert t1 == traffic.texts(WORDS, n1, BIG, "queries")
    tok = ByteTokenizer()
    for text, n in zip(t1, n1):
        assert traffic.byte_tokens(text) == n
        assert len(tok.ids(text)) == n


def test_reference_tokenizer_matches_the_port():
    from clip_lora_match_tpu_torch.tokenizer.bpe import ClipTokenizer

    port = ClipTokenizer.from_dir(None, 77)
    ref = ByteTokenizer()
    texts = traffic.texts(WORDS, traffic.token_lengths(60, 8, 40, 3), 3, "t")
    texts += ["Dompet Kulit COKLAT, ditemukan di lab kimia gedung d.", "x" * 90, "héllo wörld 12.5%"]
    assert np.array_equal(port(texts)["input_ids"].astype(np.int64), ref(texts))


def test_seeds_take_large_numbers():
    assert seeds.derive(2 ** 40 + 3, "a") != seeds.derive(2 ** 40 + 3, "b")
    assert 0 <= seeds.derive(2 ** 31 + 5, "x") < 2 ** 63


def test_percentile_over_all_requests_counts_failures_as_late():
    lat = [float(i) for i in range(1, 101)]
    assert percentile(lat, 50) == pytest.approx(50.5)
    assert percentile(lat, 95) == pytest.approx(95.05)
    # five failures of a hundred: the 95th percentile reaches them
    assert math.isinf(percentile(lat[:95] + [math.inf] * 5, 96))
    assert percentile(lat[:95] + [math.inf] * 5, 50) == pytest.approx(50.5)
    assert math.isinf(percentile([1.0, math.inf], 95))

