"""Markdown evaluation report (port of ``eval/report.py``;
ref:scripts/run_all_evaluations.py:28-137): comparison table,
best-model-per-metric section, auto-recommendations."""

from __future__ import annotations

import datetime as dt
import os
from typing import Optional

from clip_lora_match_tpu_torch.eval.comparator import BASE_NAME


def create_evaluation_report(
    results: dict,
    out_path: str,
    improvements: Optional[dict] = None,
    improvements_title: str = "Improvement vs Base",
) -> str:
    ks_metrics = ["recall@1", "recall@5", "recall@10", "mrr", "map", "matching_accuracy"]
    lines = [
        "# Model Evaluation Report",
        "",
        f"**Generated:** {dt.datetime.now().strftime('%Y-%m-%d %H:%M:%S')}",
        "",
        "---",
        "",
        "## 1. Model Comparison",
        "",
        "| Model | Recall@1 | Recall@5 | Recall@10 | MRR | mAP | Matching Acc |",
        "|-------|----------|----------|-----------|-----|-----|-------------|",
    ]
    for name, m in results.items():
        row = " | ".join(f"{m.get(k, float('nan')):.4f}" for k in ks_metrics)
        lines.append(f"| {name} | {row} |")
    lines += ["", "---", "", "## 2. Best Models", ""]
    for metric in ks_metrics if results else []:
        best = max(results.items(), key=lambda kv: kv[1].get(metric, -1))
        lines.append(f"- **{metric}**: {best[0]} ({best[1].get(metric, 0):.4f})")
    if improvements:
        lines += ["", "---", "", f"## 3. {improvements_title}", ""]
        for name, imp in improvements.items():
            lines.append(f"### {name}")
            for metric in ks_metrics:
                if metric in imp:
                    lines.append(f"- {metric}: {imp[metric]:+.1f}%")
            lines.append("")
    # auto-recommendations (ref L100-137 flavor)
    lines += ["", "---", "", "## 4. Recommendations", ""]
    non_base = {n: m for n, m in results.items() if n != BASE_NAME}
    if non_base and BASE_NAME in results:
        best_name, best_m = max(
            non_base.items(), key=lambda kv: kv[1].get("recall@1", 0)
        )
        base_r1 = results[BASE_NAME].get("recall@1", 0)
        best_r1 = best_m.get("recall@1", 0)
        lift = (best_r1 - base_r1) / base_r1 * 100 if base_r1 else 0.0
        # quote percent-vs-base only when the base is meaningfully above
        # chance — against a random-init base the ratio is pure noise, so
        # cite the absolute recall instead
        vs = (
            f"recall@1 {lift:+.0f}% vs base"
            if base_r1 >= 0.01
            else f"recall@1 {best_r1:.4f} vs a chance-level base ({base_r1:.4f})"
        )
        if best_r1 > base_r1 * 1.1 and best_r1 > base_r1 + 0.005:
            lines.append(f"- Deploy **{best_name}** ({vs}).")
        elif best_r1 > base_r1:
            lines.append(
                f"- **{best_name}** improves recall@1 ({vs}); consider "
                "more training epochs or data."
            )
        else:
            lines.append(
                "- LoRA fine-tuning is not improving recall@1; revisit the "
                "training data or hyperparameters."
            )
    else:
        lines.append("- Train a LoRA adapter to compare against the base model.")
    text = "\n".join(lines) + "\n"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path
