"""Dataset evaluator: batched dual-tower encode, then the protocols' metrics
(port of ``eval/evaluator.py``).

One batched encode pass per tower per variant through ``ClipEncoder``'s
float feed (``encode_image`` / ``encode_text``, batches of 256), in place of
the reference's per-sample loops (ref:scripts/evaluate_model.py:137-209).
Keeps the reference's tolerant data handling: flexible CSV column detection
(ref L125-133) and three image path resolutions with skip-on-missing
(ref L146-158).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.eval.protocols import diagonal_metrics, threshold_metrics
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

log = get_logger("eval")

_IMAGE_COLS = ("image_path", "image", "img_path", "filepath")
_TEXT_COLS = ("text", "caption", "description", "productDisplayName")


@dataclass
class EvalData:
    image_paths: list[str] = field(default_factory=list)
    texts: list[str] = field(default_factory=list)
    skipped: int = 0


def load_eval_csv(
    csv_path: str,
    image_root: str = ".",
    require_images: bool = True,
    max_rows: Optional[int] = None,
) -> EvalData:
    """Flexible-column CSV load with per-row image resolution fallbacks."""
    data = EvalData()
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        cols = reader.fieldnames or []
        img_col = next((c for c in _IMAGE_COLS if c in cols), None)
        txt_col = next((c for c in _TEXT_COLS if c in cols), None)
        if img_col is None or txt_col is None:
            raise ValueError(f"{csv_path}: could not detect image/text columns in {cols}")
        for row in reader:
            raw = row[img_col]
            resolved = None
            # the three resolutions of ref:evaluate_model.py:146-151
            for cand in (
                raw,
                os.path.join(image_root, raw),
                os.path.join(image_root, os.path.basename(raw)),
            ):
                if os.path.exists(cand):
                    resolved = cand
                    break
            if resolved is None and require_images:
                data.skipped += 1
                continue
            data.image_paths.append(resolved or raw)
            data.texts.append(row[txt_col])
            if max_rows and len(data.texts) >= max_rows:
                break
    if data.skipped:
        log.warning("skipped %d rows with missing images", data.skipped)
    return data


class CLIPEvaluator:
    """Batched evaluator over an (image, caption) dataset; the similarity
    products run on the encoder's device."""

    def __init__(self, encoder: ClipEncoder, batch_size: int = 256):
        self.encoder = encoder
        self.batch_size = batch_size

    def encode_dataset(self, data: EvalData) -> tuple[np.ndarray, np.ndarray]:
        imgs, txts = [], []
        B = self.batch_size
        for start in range(0, len(data.texts), B):
            imgs.append(self.encoder.encode_image(data.image_paths[start : start + B]))
            txts.append(self.encoder.encode_text(data.texts[start : start + B]))
            log.info("encoded %d/%d", min(start + B, len(data.texts)), len(data.texts))
        d = self.encoder.arch.projection_dim
        img = np.concatenate(imgs) if imgs else np.zeros((0, d), np.float32)
        txt = np.concatenate(txts) if txts else np.zeros((0, d), np.float32)
        return img, txt

    def evaluate(
        self,
        data: EvalData,
        ks: Sequence[int] = (1, 5, 10),
        threshold: float = 0.7,
        protocols: Sequence[str] = ("diagonal", "threshold"),
    ) -> dict:
        img, txt = self.encode_dataset(data)
        dev = self.encoder.device
        out: dict = {"num_samples": len(data.texts)}
        if "diagonal" in protocols:
            out["diagonal"] = diagonal_metrics(img, txt, ks, device=dev)
        if "threshold" in protocols:
            out["threshold"] = threshold_metrics(txt, txt, ks, threshold, exclude_self=True, device=dev)
        return out

    def evaluation_results_artifact(self, data: EvalData, ks=(1, 5, 10)) -> dict:
        """The shape of the reference's results/evaluation_results.json
        (``{"retrieval": {...}, "matching_accuracy": x}``)."""
        img, txt = self.encode_dataset(data)
        m = diagonal_metrics(img, txt, ks, device=self.encoder.device)
        retrieval = {k: v for k, v in m.items() if k != "matching_accuracy"}
        return {"retrieval": retrieval, "matching_accuracy": m["matching_accuracy"]}
