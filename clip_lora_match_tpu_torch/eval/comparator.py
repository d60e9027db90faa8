"""Model comparison: base CLIP against LoRA epochs (port of
``eval/comparator.py``).

The ``model_comparison.json`` shape of the reference (ref:results/
model_comparison.json: model name → metric dict with recall@k / mrr / map /
t2i_recall@k / matching_accuracy), the summary with improvement percentages
(ref:scripts/compare_models.py:251-300), and the three plots (recall bars,
metric heatmap, radar; ref:compare_models.py:151-249) when matplotlib is
there.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.eval.evaluator import CLIPEvaluator, EvalData
from clip_lora_match_tpu_torch.eval.protocols import diagonal_metrics, relative_improvement
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

log = get_logger("compare")

BASE_NAME = "Base CLIP (No LoRA)"


def epoch_name(k: int) -> str:
    return f"CLIP+LoRA (Epoch {k})"


class ModelComparator:
    """ref:scripts/compare_models.py: the base model, then each
    ``{lora_dir}/epoch_{k}`` adapter (native or PEFT) on the same encoder; a
    missing epoch is logged and skipped. The encoder's own adapter is put
    back afterwards."""

    def __init__(
        self,
        encoder: ClipEncoder,
        lora_dir: str,
        epochs: Sequence[int] = (1,),
        batch_size: int = 256,
    ):
        self.encoder = encoder
        self.lora_dir = lora_dir
        self.epochs = list(epochs)
        self.batch_size = batch_size

    def _variants(self):
        from clip_lora_match_tpu_torch.lora.adapter import load_lora

        yield BASE_NAME, None, 1.0
        for k in self.epochs:
            path = os.path.join(self.lora_dir, f"epoch_{k}")
            try:
                lora, scaling = load_lora(path, device=self.encoder.device, arch=self.encoder.arch)
            except FileNotFoundError:
                log.warning("no adapter at %s; skipping epoch %d", path, k)
                continue
            yield epoch_name(k), lora, scaling

    def compare(self, data: EvalData, ks=(1, 5, 10)) -> dict:
        results: dict = {}
        saved = (self.encoder.lora, self.encoder.lora_scaling)
        try:
            for name, lora, scaling in self._variants():
                self.encoder.attach_lora(lora, scaling)
                img, txt = CLIPEvaluator(self.encoder, self.batch_size).encode_dataset(data)
                results[name] = diagonal_metrics(img, txt, ks, device=self.encoder.device)
                log.info("%s: recall@1=%.4f", name, results[name]["recall@1"])
        finally:
            self.encoder.attach_lora(*saved)
        return results

    @staticmethod
    def summary(results: dict) -> dict:
        """Improvement % against the base for each other variant."""
        base = results.get(BASE_NAME)
        if base is None:
            return {}
        return {name: relative_improvement(base, m) for name, m in results.items() if name != BASE_NAME}

    @staticmethod
    def epoch_over_epoch(results: dict) -> dict:
        """Improvement % of each LoRA epoch against the previous epoch.

        Percent-vs-base means nothing when the base scores chance (a
        random-init base at recall@1 ≈ 1/N turns any real lift into +10⁵%
        noise); the epoch-over-epoch lift is the trajectory. Keys are
        ``"<name> vs <previous short name>"``."""
        epochs = [(name, m) for name, m in results.items() if name != BASE_NAME]
        out = {}
        for (prev_name, prev_m), (name, m) in zip(epochs, epochs[1:]):
            short_prev = prev_name.split("(")[-1].rstrip(")")
            out[f"{name} vs {short_prev}"] = relative_improvement(prev_m, m)
        return out

    @staticmethod
    def save_json(results: dict, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(results, f, indent=2)

    # -- plots (ref:compare_models.py:151-249) --------------------------------

    @staticmethod
    def plot_all(results: dict, plots_dir: str, ks=(1, 5, 10)) -> list[str]:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            log.warning("matplotlib unavailable; skipping plots")
            return []
        os.makedirs(plots_dir, exist_ok=True)
        names = list(results)
        written = []

        # 1. recall bar chart
        fig, ax = plt.subplots(figsize=(12, 6))
        width = 0.8 / max(len(names), 1)
        xs = np.arange(len(ks))
        for i, n in enumerate(names):
            vals = [results[n].get(f"recall@{k}", 0) for k in ks]
            ax.bar(xs + i * width, vals, width, label=n)
        ax.set_xticks(xs + width * (len(names) - 1) / 2)
        ax.set_xticklabels([f"R@{k}" for k in ks])
        ax.set_ylabel("recall")
        ax.set_title("Recall@k comparison")
        ax.legend()
        p = os.path.join(plots_dir, "recall_comparison.png")
        fig.savefig(p, dpi=150, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

        # 2. metric heatmap
        metrics = sorted({k for m in results.values() for k in m})
        mat = np.array([[results[n].get(m, np.nan) for m in metrics] for n in names])
        fig, ax = plt.subplots(figsize=(10, 6))
        im = ax.imshow(mat, cmap="YlGnBu", aspect="auto")
        ax.set_xticks(range(len(metrics)))
        ax.set_xticklabels(metrics, rotation=45, ha="right")
        ax.set_yticks(range(len(names)))
        ax.set_yticklabels(names)
        fig.colorbar(im)
        ax.set_title("Metrics heatmap")
        p = os.path.join(plots_dir, "metrics_heatmap.png")
        fig.savefig(p, dpi=150, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

        # 3. radar chart
        radar_metrics = [f"recall@{k}" for k in ks] + ["mrr", "matching_accuracy"]
        angles = np.linspace(0, 2 * np.pi, len(radar_metrics), endpoint=False)
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(111, polar=True)
        for n in names:
            vals = [results[n].get(m, 0) for m in radar_metrics]
            ax.plot(np.concatenate([angles, angles[:1]]), vals + vals[:1], label=n)
            ax.fill(np.concatenate([angles, angles[:1]]), vals + vals[:1], alpha=0.1)
        ax.set_xticks(angles)
        ax.set_xticklabels(radar_metrics)
        ax.legend(loc="upper right", bbox_to_anchor=(1.3, 1.1))
        ax.set_title("Model comparison radar")
        p = os.path.join(plots_dir, "radar_comparison.png")
        fig.savefig(p, dpi=150, bbox_inches="tight")
        plt.close(fig)
        written.append(p)
        return written
