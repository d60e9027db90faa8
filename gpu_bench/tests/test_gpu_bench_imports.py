"""The check of what the measured process loaded compares whole top-level
names; the harness and the reference load no JAX, and the reference nothing
of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from gpu_bench.harness.imports import forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]


def test_whole_names():
    assert forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert forbidden_loaded(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert forbidden_loaded(["clip_lora_match_tpu.models.clip"]) == ["clip_lora_match_tpu"]
    assert forbidden_loaded(["clip_lora_match_tpu_torch", "clip_lora_match_tpu_torch.ops._build"]) == []
    assert forbidden_loaded(["jaxtyping", "flaxen", "clip_lora_match_tpu2"]) == []


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_and_counts_import_nothing_of_the_port():
    for sub in ("reference", "counts"):
        for path in (BENCH / sub).glob("*.py"):
            names = _imports(path)
            assert not names & {"clip_lora_match_tpu_torch", "clip_lora_match_tpu", "jax", "jaxlib", "flax"}, path


def test_a_process_running_the_harness_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import gpu_bench.harness.runner, gpu_bench.harness.program, gpu_bench.reference.train\n"
        "import gpu_bench.reference.topk, gpu_bench.counts.kernels\n"
        "from gpu_bench.harness.manifest import Bench\n"
        "b = Bench(); [b.driver(k) for k in ('seek_closed_loop', 'embed_batches', 'train_steps')]\n"
        "import clip_lora_match_tpu_torch.services, clip_lora_match_tpu_torch.train.step\n"
        "from gpu_bench.harness.imports import forbidden_loaded\n"
        "print(forbidden_loaded())\n"
    ) % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240,
                         cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card(tmp_path):
    """On the CPU the command exits non-zero and prints nothing on stdout."""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "b32-seek-text-4m", "--seed",
                          str(2 ** 33), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=240, cwd=str(BENCH.parent))
    assert out.returncode != 0 and out.stdout == ""
