"""The benchmark of the PyTorch/CUDA port (``clip_lora_match_tpu_torch``).

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout on a machine
with a CUDA card: set-up and warm-up, a measured window of ``--seconds``,
then the comparison with the plain reference that decides ``correct``. The
last line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and ``checks``: each number compared beside its limit, which the last lines
of standard error repeat). With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled sub-window in the middle of the window.

It exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), when a module of JAX or of the JAX package
is loaded in this process once the window has closed, or when the traced
run's device record is incomplete. The port's kernel and build caches live
under ``build/`` inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program at a fixed path inside the checkout; no JAX
# through a library that would load it on its own
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "gpu_bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "gpu_bench_cache" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _finite(x):
    """JSON has no infinity: a value that is not finite prints as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpu_bench.harness.imports import forbidden_loaded
    from gpu_bench.harness.manifest import Bench
    from gpu_bench.harness.runner import print_checks, run_cell

    bench = Bench(ROOT)
    chips = int(bench.cell(args.workload).get("chips", 1))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpu_bench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    def jax_free() -> None:
        found = forbidden_loaded()
        if found:
            raise SystemExit(f"gpu_bench: modules of JAX or the JAX package are loaded: {', '.join(found)}")

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, on_window_closed=jax_free)
    jax_free()
    print_checks(result)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
