"""Every per-layer metric's reader runs on a tiny cell's driver and a
synthetic device record, and returns a number or nothing; none returns 0
for a share of a roofline or of a peak."""


import pytest
import torch

from gpu_bench.harness import trace as tracing
from gpu_bench.harness.manifest import Bench
from gpu_bench.harness.runner import Reading, make_ctx
from gpu_bench.tests.tiny import BENCH, make_root

KIND = {"seek_closed_loop": "tiny-seek", "embed_batches": "tiny-embed", "train_steps": "tiny-train"}


def _trace(driver):
    """A record whose window covers the driver's window, with kernels of the
    names the readers look for inside each host span of the driver."""
    t0 = driver.t0
    spans = [(s[0], s[1]) for s in getattr(driver, "spans", [])] or [(t0 + 0.01, t0 + 0.02)]
    device = [tracing.Interval("tilemax_kernel<0, 1>", t0 + 0.01, t0 + 0.0103, 1, "kernel")]
    for i, (s, e) in enumerate(spans):
        device.append(tracing.Interval("Memcpy HtoD (Pageable -> Device)", s, s + 0.01 * (e - s), 100 + i, "gpu_memcpy"))
        device.append(tracing.Interval("lora_matmul_tma_kernel<128, 128, 8>", s + 0.1 * (e - s), s + 0.4 * (e - s),
                                       10 + i, "kernel"))
    tr = tracing.Trace((t0, t0 + driver.ctx.seconds), device, [], [], t0 + driver.ctx.seconds)
    tr.host_window = (t0, t0 + driver.ctx.seconds)
    tr.overhead = (t0 + 0.5 * driver.ctx.seconds, t0 + 0.5 * driver.ctx.seconds + 0.01)
    return tr


@pytest.mark.parametrize("kind", sorted(KIND))
def test_readers_run(tmp_path, kind):
    bench = Bench(make_root(tmp_path))
    real = Bench(BENCH.parent)
    ctx = make_ctx(bench, KIND[kind], 2 ** 32 + 3, torch.device("cpu"), 0.5)
    driver = bench.driver(kind).Driver(ctx)
    driver.setup()
    window_s = driver.window(0.5, None)
    tr = _trace(driver)
    kinds = {c["name"]: real.traffic(c["traffic"])["driver"] for c in real.manifest["workloads"]}
    names = {m["name"]: m for m in real.manifest["per_layer"]
             if any(kinds[c] == kind for c in m.get("workloads", []))}
    assert names
    for name, m in names.items():
        value = real.metric_reader(name).read(Reading(ctx, driver, tr, window_s))
        assert value is None or isinstance(value, float), name
        if value is not None and ("roofline" in name or "mfu" in name):
            assert value > 0, name
    driver.free()
