"""Readings that a cell's limits are set from, on the card, several seeds in
one process.

    python3 gpu_bench/control.py --workload <cell> --control <none|name> --seeds 11,12,13 --seconds 3

For each seed, one run of the cell as ``run.py`` makes it (``run_cell``),
with the control in the program's place (or none: the program as the
configuration states it) and a short window at the cell's own load. Prints
one JSON line a seed with each compared number beside the cell's limit. The
controls are each driver's: ``int8_tower`` and ``bf16_index`` (seek),
``int8_tower`` (embed), ``tf32`` and the planted faults ``half_batch`` and
``unchanged`` (train). The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", default="none")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()

    import torch

    from gpu_bench.harness.manifest import Bench
    from gpu_bench.harness.runner import run_cell

    bench = Bench(ROOT)
    control = None if args.control == "none" else args.control
    gpu = torch.cuda.get_device_name(0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(bench, args.workload, seed, args.seconds, False, torch.device("cuda", 0), t,
                       control=control)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": out["correct"], "failed": out["failed"], "attempted": out["attempted"],
                          "metrics": out["metrics"], "checks": out["checks"],
                          "seconds": time.perf_counter() - t, "device": gpu}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
