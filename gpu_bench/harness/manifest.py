"""Finds everything of a run by the names in ``BENCHMARK.json``.

A cell is ``gpu_bench/workloads/<cell>.json``; its configuration is the file
that ``BENCHMARK.json`` names for it (``gpu_bench/configs/<config>.json``);
its traffic mix is ``gpu_bench/traffic/<traffic>.json``, whose ``driver``
names the general generator ``gpu_bench/drivers/<driver>.py``; a per-layer
metric is read by ``gpu_bench/metrics/<metric>.py``. A later cell, mix,
configuration or metric is a new file and a new entry: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = "gpu_bench"


def _load_module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    name = f"gpu_bench_{tag}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """The benchmark as a checkout at ``root`` describes it."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR
        self.manifest = _read_json(self.root / "BENCHMARK.json")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.manifest[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        """The cell's manifest entry merged with its workload file."""
        entry = self._entry("workloads", name)
        data = _read_json(self.dir / "workloads" / f"{name}.json")
        if data.get("config", entry["config"]) != entry["config"]:
            raise ValueError(f"{name}: workload file and BENCHMARK.json name other configurations")
        if data.get("traffic", entry["traffic"]) != entry["traffic"]:
            raise ValueError(f"{name}: workload file and BENCHMARK.json name other traffic")
        return {**data, **entry}

    def config(self, name: str) -> dict:
        return _read_json(self.root / self._entry("configs", name)["file"])

    def traffic(self, name: str) -> dict:
        return _read_json(self.dir / "traffic" / f"{name}.json")

    def data_file(self, name: str) -> dict:
        """A data file the traffic mixes share (``gpu_bench/traffic/<name>``)."""
        return _read_json(self.dir / "traffic" / name)

    def driver(self, kind: str):
        return _load_module(self.dir / "drivers" / f"{kind}.py", "driver")

    def metric_reader(self, name: str):
        return _load_module(self.dir / "metrics" / f"{name}.py", "metric")

    def _reports(self, metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.manifest["end_to_end"] if self._reports(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        """Per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        out = []
        for m in self.manifest["per_layer"]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out
