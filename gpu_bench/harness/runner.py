"""One run of one cell: set-up, warm-up, the measured window, and the check
that decides ``correct``, with every number the result line carries.

``run_cell`` takes its device from the caller: ``run.py`` refuses to start
without the card, and the CPU tests drive the same path on the CPU at tiny
sizes.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass

from gpu_bench.harness import trace as tracing
from gpu_bench.harness.manifest import Bench


@dataclass
class Ctx:
    """What a driver is given: the cell's entry and files, the seed, the
    device, and which control (a lower precision of the program, for the
    readings a limit is set from) or planted fault replaces the timed path."""

    bench: Bench
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    seconds: float
    control: str | None = None


@dataclass
class Reading:
    """What a per-layer metric's reader is given."""

    ctx: Ctx
    driver: object
    trace: tracing.Trace | None
    window_s: float


def _sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()


def device_info(device, count: int) -> dict:
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def make_ctx(bench: Bench, name: str, seed: int, device, seconds: float, control=None) -> Ctx:
    cell = bench.cell(name)
    return Ctx(bench, name, cell, bench.config(cell["config"]), bench.traffic(cell["traffic"]),
               int(seed), device, float(seconds), control)


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: str | None = None, on_window_closed=None) -> dict:
    """The result line of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` when traced, ``checks`` last).
    ``on_window_closed`` is called as soon as the window has closed (the
    caller's check of what the process loaded)."""
    ctx = make_ctx(bench, name, seed, device, seconds, control)
    driver = bench.driver(ctx.traffic["driver"]).Driver(ctx)
    driver.setup()
    if trace:
        tracing.SubWindow.warm(device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    sub = None
    if trace:
        prof = ctx.cell["profile"]
        sub = tracing.SubWindow(prof["start_after_s"], prof["seconds"])
    window_s = driver.window(seconds, sub)
    _sync(device)
    if on_window_closed is not None:
        on_window_closed()
    info = device_info(device, int(ctx.cell.get("chips", 1)))
    tr = sub.finish() if sub is not None else None

    metrics: dict = {}
    breakdown = None
    if not trace:
        values = {"setup_s": setup_s, **driver.end_to_end()}
        for m in bench.end_to_end(name):
            if m["name"] not in values:
                raise KeyError(f"{name}: the driver gives no end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        reading = Reading(ctx, driver, tr, window_s)
        for m in bench.per_layer(name):
            value = bench.metric_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = tracing.busy_s(tr)
        if not busy > 0:
            raise tracing.IncompleteTrace("no device activity in the profiled sub-window")
        info["busy_s"] = busy
        info["window_s"] = tr.window_s
        breakdown = tracing.breakdown(tr)

    driver.free()
    values = driver.check()
    limits = ctx.cell["limits"]
    checks = {}
    for key, value in values.items():
        limit = limits[key]
        checks[key] = {"value": value, "limit": limit}
    correct = (driver.failed == 0 and all(
        not math.isnan(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    for err in sorted(set(getattr(driver, "errors", [])))[:3]:
        print(f"a failed request or batch raised: {err}", file=sys.stderr)
    out = {"correct": correct, "attempted": driver.attempted, "failed": driver.failed,
           "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def print_checks(result: dict, stream=sys.stderr) -> None:
    """Each compared number beside its limit, as the last lines."""
    print(f"failed requests or steps: {result['failed']} of {result['attempted']} (limit 0)", file=stream)
    for key, c in result["checks"].items():
        print(f"{key}: {c['value']!r} (limit {c['limit']!r})", file=stream)
    print(f"correct: {str(result['correct']).lower()}", file=stream, flush=True)
