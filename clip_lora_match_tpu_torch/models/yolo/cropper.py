"""YOLO object cropper, the region-extraction stage (port of
``models/yolo/cropper.py``).

The reference's semantics: detect with the config's conf / iou / max_det
(0.25 / 0.45 / 5); clamp each box to the image as integers; save each crop as
``{stem}_crop_{idx}.jpg`` under ``save_dir``; save the full image as crop 0
when nothing is detected; ``crop_folder`` over a directory. The detector is
pluggable: the PyTorch YOLOv8 (``models/yolo/yolov8.py``) when weights are
found, else ``NullDetector``, which detects nothing and so always takes the
full-image fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence

import torch
from PIL import Image

from clip_lora_match_tpu_torch.core.config import YoloConfig, load_yolo_config
from clip_lora_match_tpu_torch.core.device import resolve_device
from clip_lora_match_tpu_torch.core.logging import get_logger

log = get_logger("yolo")


@dataclass
class Detection:
    box: tuple[float, float, float, float]  # xyxy in original image coords
    score: float
    class_id: int


class Detector(Protocol):
    def detect(
        self, image: Image.Image, conf: float, iou: float, max_det: int,
        classes: Optional[Sequence[int]] = None, agnostic: bool = False,
    ) -> list[Detection]: ...


class NullDetector:
    """Detects nothing: every crop is the full-image fallback."""

    def detect(self, image, conf, iou, max_det, classes=None, agnostic=False):
        return []


class YoloCropper:
    def __init__(self, detector: Optional[Detector] = None, config: Optional[YoloConfig] = None):
        self.cfg = config or YoloConfig()
        self.detector = detector or NullDetector()

    def _crop_path(self, image_path: str, idx: int, save_dir: Optional[str]) -> str:
        stem = os.path.splitext(os.path.basename(image_path))[0]
        name = self.cfg.filename_pattern.format(stem=stem, idx=idx)
        return os.path.join(save_dir or self.cfg.crop_save_dir, name)

    def crop_image(self, image_path: str, save_dir: Optional[str] = None) -> list[str]:
        """→ the saved crop paths; [the full image as crop 0] when nothing
        is detected or every box is dropped."""
        img = Image.open(image_path).convert("RGB")
        w, h = img.size
        detections = self.detector.detect(
            img,
            conf=self.cfg.conf_threshold,
            iou=self.cfg.iou_threshold,
            max_det=self.cfg.max_det,
            classes=self.cfg.classes,
            agnostic=self.cfg.agnostic_nms,
        )
        out_dir = save_dir or self.cfg.crop_save_dir
        os.makedirs(out_dir, exist_ok=True)
        paths: list[str] = []
        min_area = self.cfg.min_box_frac * w * h
        for idx, det in enumerate(detections):
            x1, y1, x2, y2 = det.box
            x1, y1 = max(0, int(x1)), max(0, int(y1))
            x2, y2 = min(w, int(x2)), min(h, int(y2))
            if x2 <= x1 or y2 <= y1:
                continue
            if (x2 - x1) * (y2 - y1) < min_area:  # opt-in degenerate-crop guard
                continue
            path = self._crop_path(image_path, idx, save_dir)
            img.crop((x1, y1, x2, y2)).save(path)
            paths.append(path)
        if not paths:
            path = self._crop_path(image_path, 0, save_dir)
            img.save(path)
            paths.append(path)
            log.info("no detections for %s; saved full image", image_path)
        return paths

    def crop_folder(
        self,
        folder: str,
        save_dir: Optional[str] = None,
        extensions: Sequence[str] = (".jpg", ".jpeg", ".png", ".webp"),
    ) -> dict[str, list[str]]:
        """Crop every image in a folder; a failed image maps to []."""
        results: dict[str, list[str]] = {}
        for name in sorted(os.listdir(folder)):
            if os.path.splitext(name)[1].lower() not in extensions:
                continue
            path = os.path.join(folder, name)
            try:
                results[path] = self.crop_image(path, save_dir)
            except Exception as e:
                log.warning("crop failed for %s: %s", path, e)
                results[path] = []
        return results


# default weights, probed in order when the config's weights_path is absent:
# the committed synthetic-corpus checkpoints
DEFAULT_WEIGHT_PATHS = (
    "models/yolo_synth/yolov8s_synth.npz",
    "models/yolo_synth/yolov8n_synth.npz",
)


def _repo_relative(path: str) -> str:
    """Resolve a default weight path against the repository root too, so a
    cropper built from another working directory still finds the committed
    weights."""
    if os.path.exists(path):
        return path
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, path)


def load_yolo_cropper(
    config_path: Optional[str] = None,
    weights_path: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> YoloCropper:
    """A cropper over the first weights found (the argument, the config's
    path, the committed checkpoints) on ``device``, else a ``NullDetector``.
    A device without CUDA raises here; weights that fail to load are logged
    and the next candidate is tried. Only the host's read and parse of a
    file is guarded: the move to the device raises as it is."""
    from clip_lora_match_tpu_torch.models.yolo.yolov8 import YoloV8Detector, params_from_jax, read_detector

    dev = resolve_device(device)
    cfg = load_yolo_config(config_path)
    candidates = [weights_path or cfg.weights_path]
    candidates += [_repo_relative(p) for p in DEFAULT_WEIGHT_PATHS]
    detector: Detector = NullDetector()
    for weights in candidates:
        if weights and os.path.exists(weights):
            try:
                tree, wcfg = read_detector(weights, cfg)
            except Exception as e:  # a corrupt file of any kind: try the next one
                log.warning("YOLO weights load failed at %s (%s)", weights, e)
                continue
            detector = YoloV8Detector(params_from_jax(tree, dev), wcfg, device=dev)
            log.info("YOLO detector loaded from %s", weights)
            break
    else:
        log.info("no YOLO weights at %s; NullDetector (full-image crops)", candidates)
    return YoloCropper(detector, cfg)
