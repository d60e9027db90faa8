"""The sweep that a seek cell's number of seekers was chosen from.

    python3 gpu_bench/sweep.py --workload <seek cell> --seed <n> --seconds <s> --seekers 4,8,16,32

One set-up, then one closed-loop window for each number of seekers in turn
(the cell's traffic, its ``seekers`` replaced). Prints a JSON line each:
the queries served per second, the median and 95th-percentile wait, and
the mean requests per text-tower pass. The service is saturated where more
seekers no longer raise the rate; the cell takes a number past that point.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seekers", required=True)
    args = ap.parse_args()

    import torch

    from gpu_bench.harness.manifest import Bench
    from gpu_bench.harness.runner import make_ctx
    from gpu_bench.harness.stats import percentile

    bench = Bench(ROOT)
    counts = [int(n) for n in args.seekers.split(",")]
    ctx = make_ctx(bench, args.workload, args.seed, torch.device("cuda", 0), args.seconds)
    driver = bench.driver(ctx.traffic["driver"]).Driver(ctx)
    driver.tr["seekers"] = counts[0]
    driver.setup()
    gpu = torch.cuda.get_device_name(0)
    for i, n in enumerate(counts):
        if i:
            driver.proxy.calls.clear()
            driver.start_seekers(n)
        driver.window(args.seconds, None)
        lat = list(driver.latencies_ms())
        print(json.dumps({
            "seekers": n, "requests": driver.attempted, "failed": driver.failed,
            "queries_per_s": driver.end_to_end()["queries_per_s"],
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "tower_batch": sum(c[2] for c in driver.proxy_calls) / max(1, len(driver.proxy_calls)),
            "device": gpu,
        }), flush=True)
    driver.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
