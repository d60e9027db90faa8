"""``search_batch.seek``: the mean count of the program's ``search.locked``
spans inside the measured window; nothing from a program without the
recorder, or whose ``search.locked`` spans carry no count (a checkout whose
searches do not share passes)."""

import pytest

from clip_lora_match_tpu_torch.core import profiling
from gpu_bench.tests.test_gpu_bench_program_spans import SEEK_DEVICE, SEEK_SPANS, _read, _recorder, _trace

# the window is 10.0-11.0 s on time.perf_counter; the profiler's own start
# and stop lie over 10.85-10.86 s
PASSES = [
    ("search.locked", 9.9, 10.05, 8),      # opens before the window: left out
    ("search.locked", 10.1, 10.12, 3),
    ("search.locked", 10.3, 10.31, 1),
    ("search.locked", 10.5, 10.52, 5),
    ("search.locked", 10.6, 10.62, None),  # a search_batch hold: no count
    ("search.locked", 10.852, 10.854, 9),  # inside the profiler's start and stop: left out
    ("search.locked", 10.99, 11.02, 2),    # past the window's close: left out
]


@pytest.mark.parametrize("spans", [None, [], SEEK_SPANS], ids=["no_recorder", "no_spans", "no_counts"])
def test_nothing_without_counted_passes(monkeypatch, spans):
    if spans is None:
        monkeypatch.delattr(profiling, "RECORDER")
    else:
        monkeypatch.setattr(profiling, "RECORDER", _recorder(spans))
    assert _read("search_batch.seek", _trace(SEEK_DEVICE)) is None


def test_the_mean_count_of_the_windows_passes(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", _recorder(SEEK_SPANS + PASSES))
    assert _read("search_batch.seek", _trace(SEEK_DEVICE)) == pytest.approx(3.0)
