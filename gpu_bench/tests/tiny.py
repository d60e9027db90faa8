"""A checkout in a temporary directory whose benchmark has tiny cells of the
three drivers, for driving the harness on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_WIDTHS = {
    "image_size": 32, "patch_size": 16, "vision_width": 64, "vision_layers": 2, "vision_heads": 2,
    "vision_mlp_dim": 128, "vocab_size": 514, "max_text_length": 77, "text_width": 64,
    "text_layers": 2, "text_heads": 2, "text_mlp_dim": 128, "projection_dim": 32,
    "layer_norm_eps": 1e-05, "hidden_act": "quick_gelu",
}

CELLS = {
    "tiny-seek": {
        "traffic": "tiny_seek",
        "traffic_file": {"driver": "seek_closed_loop", "index_rows": 3000, "top_k": 5, "token_lengths": [8, 40],
                         "words": "lost_found_words.json", "max_batch": 64, "linger_ms": 2.0,
                         "text_pool": 512, "check_requests": 24, "check_longest": 2},
        "load": {"seekers": 4},
        "limits": {"tower_err": 1e-4, "search_err": 1e-4},
    },
    "tiny-embed": {
        "traffic": "tiny_embed",
        "traffic_file": {"driver": "embed_batches", "batch": 4, "pool_batches": 2, "check_images": 6},
        "limits": {"embed_err": 1e-4},
    },
    "tiny-train": {
        "traffic": "tiny_train",
        "traffic_file": {"driver": "train_steps", "batch": 8, "pool_batches": 4, "token_lengths": [8, 40],
                         "words": "lost_found_words.json", "text_seq_slice": 64, "logging_steps": 50,
                         "optimizer": {"learning_rate": 0.01, "weight_decay": 0.01, "warmup_ratio": 0.1,
                                       "max_grad_norm": 1.0, "temperature": 0.07, "total_steps": 20}},
        "limits": {"loss_err": 1e-4, "grad_err": 1e-3, "update_err": 1e-3},
    },
}


def make_root(tmp: Path) -> Path:
    """A checkout holding this benchmark's folder and a BENCHMARK.json of
    the tiny cells."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "gpu_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "gpu_bench" / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "source": "tests", "model_name": "tiny", "widths": TINY_WIDTHS,
        "lora": {"r": 4, "alpha": 8, "dropout": 0.0, "target_modules": ["q_proj", "k_proj", "v_proj", "out_proj"],
                 "b_std": 0.05},
        "serving_compute_dtype": "bfloat16", "reduced": []}))
    workloads, e2e = [], []
    for name, c in CELLS.items():
        (root / "gpu_bench" / "traffic" / f"{c['traffic']}.json").write_text(json.dumps(c["traffic_file"]))
        body = {"config": "tiny", "traffic": c["traffic"], "limits": c["limits"],
                "profile": {"start_after_s": 0.15, "seconds": 0.2}}
        if "load" in c:
            body["load"] = c["load"]
        (root / "gpu_bench" / "workloads" / f"{name}.json").write_text(json.dumps(body))
        workloads.append({"name": name, "config": "tiny", "traffic": c["traffic"], "chips": 1, "why": "test"})
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "tiny", "source": "tests", "file": "gpu_bench/configs/tiny.json",
                            "reduced": [], "why": "test"}]
    manifest["workloads"] = workloads
    seek = ["tiny-seek"]
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = {"queries_per_s": seek, "images_per_s": ["tiny-embed"],
                              "train_pairs_per_s": ["tiny-train"]}[m["name"]]
    manifest["per_layer"] = []
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
