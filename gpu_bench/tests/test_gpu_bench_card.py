"""On the card, at a size a test run holds: each cell's program, as its
configuration states it, passes the cell's own limits, and each control
(the lower precision that would tempt a later change) fails them. The seek
cells run over a 262,144-row index and a short window; the others as the
cells run. Run on the card: ``python -m pytest gpu_bench/tests -q -m card``."""

import json
import time

import pytest

from gpu_bench.harness.manifest import Bench
from gpu_bench.harness.runner import run_cell

pytestmark = pytest.mark.card
SEED = 2 ** 34 + 5


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """This checkout's benchmark with the seek traffic over fewer rows."""
    import shutil

    from gpu_bench.tests.tiny import BENCH

    root = tmp_path_factory.mktemp("card") / "checkout"
    shutil.copytree(BENCH, root / "gpu_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "gpu_bench" / "traffic" / "seek_text_4m.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "index_rows": 262_144}))
    return Bench(root)


CASES = [
    ("b32-seek-text-4m", None, True), ("b32-seek-text-4m", "int8_tower", False),
    ("b32-seek-text-4m", "bf16_index", False),
    ("l14-embed-images", None, True), ("l14-embed-images", "int8_tower", False),
    ("b32-train-lora", None, True), ("b32-train-lora", "tf32", False),
    ("b32-train-lora", "half_batch", False), ("b32-train-lora", "unchanged", False),
]


@pytest.mark.parametrize("cell,control,correct", CASES)
def test_control_fails_and_program_passes(card, small, cell, control, correct):
    out = run_cell(small, cell, SEED, 2.0, False, card, time.perf_counter(), control=control)
    assert out["correct"] is correct, out["checks"]
