"""Detector box post-processing: fixed-size NMS and box helpers (port of
``models/yolo/postprocess.py``).

``nms_fixed`` is the JAX package's static-shape greedy NMS: exactly
``max_det`` slots with a validity mask, sorted by descending score, invalid
slots zeroed and their classes -1. It runs on the device of its inputs with a
leading batch axis, and reads nothing back: each of the ``max_det`` steps is
a handful of tensor ops, ``keep`` is a tensor, and the selected rows are
gathered with index tensors.
"""

from __future__ import annotations

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (N, 4) and (M, 4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    max_det: int = 5,
    agnostic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS with static output shapes.

    boxes (..., N, 4) xyxy, scores (..., N), classes (..., N) integer →
    (boxes (..., max_det, 4), scores (..., max_det), classes (..., max_det)
    int32, valid (..., max_det) bool). A score below ``conf_threshold`` never
    survives; the first index wins a tie; a box whose IoU with the pick is at
    least ``iou_threshold`` is suppressed, within the pick's class unless
    ``agnostic``.
    """
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    boxes = boxes.reshape(-1, n, 4)
    live = scores.reshape(-1, n)
    classes = classes.reshape(-1, n).to(torch.int32)
    live = torch.where(live >= conf_threshold, live, torch.zeros_like(live))
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    picks, kept = [], []
    for _ in range(max_det):
        best = live.argmax(dim=1, keepdim=True)  # (B, 1), first index on ties
        best_score = live.gather(1, best)
        bb = boxes.gather(1, best[..., None].expand(-1, 1, 4))  # (B, 1, 4)
        lt = torch.maximum(boxes[..., :2], bb[..., :2])
        rb = torch.minimum(boxes[..., 2:], bb[..., 2:])
        wh = (rb - lt).clamp_min(0)
        inter = wh[..., 0] * wh[..., 1]
        iou_row = inter / (area + area.gather(1, best) - inter).clamp_min(1e-9)
        suppress = iou_row >= iou_threshold
        if not agnostic:
            suppress = suppress & (classes == classes.gather(1, best))
        live = torch.where(suppress, torch.zeros_like(live), live)
        live = live.scatter(1, best, 0.0)
        picks.append(best)
        kept.append(best_score)
    idx = torch.cat(picks, dim=1)  # (B, max_det)
    kept_scores = torch.cat(kept, dim=1)
    valid = kept_scores > 0.0
    out_boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_scores = torch.where(valid, kept_scores, torch.zeros_like(kept_scores))
    out_classes = torch.where(valid, classes.gather(1, idx), torch.full_like(idx, -1, dtype=torch.int32))
    return (
        out_boxes.reshape(*lead, max_det, 4),
        out_scores.reshape(*lead, max_det),
        out_classes.reshape(*lead, max_det),
        valid.reshape(*lead, max_det),
    )


def decode_boxes(xywh: torch.Tensor) -> torch.Tensor:
    """(N, 4) center-xywh → xyxy."""
    cx, cy, w, h = xywh.unbind(1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=1)


def clamp_boxes(boxes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Clamp xyxy boxes to the image bounds."""
    return torch.stack(
        [
            boxes[:, 0].clamp(0, width),
            boxes[:, 1].clamp(0, height),
            boxes[:, 2].clamp(0, width),
            boxes[:, 3].clamp(0, height),
        ],
        dim=1,
    )
