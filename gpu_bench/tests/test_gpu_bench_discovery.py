"""A cell, a traffic mix, a configuration and a per-layer metric added as
new files plus manifest entries are found by name, with no edit to a file
that was there."""

import json
import time

import torch

from gpu_bench.harness.manifest import Bench
from gpu_bench.harness.runner import Reading, make_ctx, run_cell
from gpu_bench.tests.tiny import make_root


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "gpu_bench").rglob("*") if p.is_file()}
    g = root / "gpu_bench"
    cfg = json.loads((g / "configs" / "tiny.json").read_text())
    cfg["name"] = "tiny-wide"
    cfg["widths"] = dict(cfg["widths"], projection_dim=48)
    (g / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    (g / "traffic" / "tiny_seek_slow.json").write_text(json.dumps(
        {**json.loads((g / "traffic" / "tiny_seek.json").read_text()), "index_rows": 2000}))
    (g / "workloads" / "tiny-wide-seek.json").write_text(json.dumps(
        {"config": "tiny-wide", "traffic": "tiny_seek_slow", "load": {"seekers": 2},
         "profile": {"start_after_s": 0.15, "seconds": 0.2},
         "limits": {"tower_err": 1e-4, "search_err": 1e-4}}))
    (g / "metrics" / "requests_done.seek.py").write_text(
        "def read(r):\n    return float(len(r.driver.done))\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-wide", "source": "tests", "file": "gpu_bench/configs/tiny-wide.json",
                         "reduced": ["projection_dim"], "why": "test"})
    m["workloads"].append({"name": "tiny-wide-seek", "config": "tiny-wide", "traffic": "tiny_seek_slow",
                           "chips": 1, "why": "test"})
    for e in m["end_to_end"]:
        if e["name"] == "queries_per_s":
            e["workloads"].append("tiny-wide-seek")
    m["per_layer"].append({"name": "requests_done.seek", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "Service", "moves": "queries_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    bench = Bench(root)
    assert bench.cell("tiny-wide-seek")["config"] == "tiny-wide"
    assert bench.config("tiny-wide")["widths"]["projection_dim"] == 48
    assert bench.traffic("tiny_seek_slow")["index_rows"] == 2000
    assert [x["name"] for x in bench.per_layer("tiny-wide-seek")] == ["requests_done.seek"]
    assert [x["name"] for x in bench.per_layer("tiny-seek")] == ["requests_done.seek"]
    assert bench.per_layer("tiny-train") == []
    assert {x["name"] for x in bench.end_to_end("tiny-wide-seek")} == {"queries_per_s", "setup_s"}

    out = run_cell(bench, "tiny-wide-seek", 2 ** 32 + 1, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"queries_per_s", "setup_s"}
    ctx = make_ctx(bench, "tiny-wide-seek", 1, torch.device("cpu"), 0.5)
    reader = bench.metric_reader("requests_done.seek")

    class Done:
        done = {0: 1.0, 1: 2.0}

    assert reader.read(Reading(ctx, Done(), None, 0.5)) == 2.0
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())
