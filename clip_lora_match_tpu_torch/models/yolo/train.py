"""YOLOv8 detection training in PyTorch (port of ``models/yolo/train.py``).

The reference never trains YOLO (it downloads a pretrained ultralytics
yolov8s, ref:models/yolo_model.py:20-39); the repository earns its detector
weights on the synthetic detection corpus, whose boxes are exact by
construction (``scripts/generate_fashion_corpus.py --detect``). The recipe,
as the JAX package writes it:

- **Task-aligned assignment (TAL)**: per GT, the candidates are the anchors
  whose centre lies inside the box; alignment metric ``score^0.5 · IoU^6``;
  the top 10 candidates per GT become positives; an anchor claimed by
  several GTs goes to the one it overlaps most (the first on a tie, as
  ``jnp.argmax``); the soft label is ``norm_align_metric``.
- **Losses** (weights box 7.5 / cls 0.5 / dfl 1.5): IoU-scaled BCE over
  every anchor and class, CIoU on positives, the distribution focal loss of
  the ltrb distances against their two adjacent bins; each over the summed
  target scores.

Everything is static-shape: GT boxes come padded to ``max_boxes`` with a
validity mask, and the assignment is dense (B, M, N) masked math over the
batch. The convolutions are the detector's (``F.conv2d``, cuDNN on the
card); the assignment and the losses are plain PyTorch, as they are plain
XLA in the JAX package. The maps are NCHW. The step runs in fp32 and leaves
TF32 as the process set it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from clip_lora_match_tpu_torch.core.device import resolve_device
from clip_lora_match_tpu_torch.models.io import tree_leaves
from clip_lora_match_tpu_torch.models.yolo.yolov8 import REG_MAX, STRIDES, forward
from clip_lora_match_tpu_torch.train.step import apply_updates, batch_to_device, global_norm

Params = dict[str, Any]

# the ultralytics defaults
TAL_ALPHA = 0.5
TAL_BETA = 6.0
TAL_TOPK = 10
W_BOX, W_CLS, W_DFL = 7.5, 0.5, 1.5


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def make_anchors(
    imgsz: int, strides=STRIDES, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (anchor centres (N, 2) in pixels, stride per anchor (N,)), fp32."""
    pts, sts = [], []
    for s in strides:
        g = imgsz // s
        ys, xs = np.meshgrid((np.arange(g) + 0.5) * s, (np.arange(g) + 0.5) * s, indexing="ij")
        pts.append(np.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        sts.append(np.full(g * g, s, np.float32))
    dev = resolve_device(device)
    return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(dev),
            torch.from_numpy(np.concatenate(sts)).to(dev))


def plain_iou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) predictions × (..., M, 4) GTs, xyxy → (..., M, N) IoU."""
    p, g = pred[..., None, :, :], gt[..., :, None, :]
    iw = (torch.minimum(p[..., 2], g[..., 2]) - torch.maximum(p[..., 0], g[..., 0])).clamp_min(0)
    ih = (torch.minimum(p[..., 3], g[..., 3]) - torch.maximum(p[..., 1], g[..., 1])).clamp_min(0)
    inter = iw * ih
    pa = (pred[..., 2] - pred[..., 0]).clamp_min(0) * (pred[..., 3] - pred[..., 1]).clamp_min(0)
    ga = (gt[..., 2] - gt[..., 0]).clamp_min(0) * (gt[..., 3] - gt[..., 1]).clamp_min(0)
    return inter / (pa[..., None, :] + ga[..., :, None] - inter).clamp_min(1e-9)


# ---------------------------------------------------------------------------
# task-aligned assignment, batched
# ---------------------------------------------------------------------------


def assign_tal(
    pred_boxes: torch.Tensor,   # (B, N, 4) xyxy pixels (decoded, detached)
    pred_scores: torch.Tensor,  # (B, N, C) sigmoid probabilities
    anchors: torch.Tensor,      # (N, 2) centres
    gt_boxes: torch.Tensor,     # (B, M, 4) xyxy, padded
    gt_cls: torch.Tensor,       # (B, M) int
    gt_valid: torch.Tensor,     # (B, M) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (fg_mask (B, N), assigned_gt (B, N) int64, target_score (B, N),
    assigned_iou (B, N)): the JAX package's ``assign_tal`` of each image.
    ``target_score`` is the task-aligned soft label of the assigned class."""
    B, N, C = pred_scores.shape
    M = gt_boxes.shape[1]
    ax, ay = anchors[:, 0], anchors[:, 1]
    in_gt = (
        (ax > gt_boxes[..., 0, None]) & (ax < gt_boxes[..., 2, None])
        & (ay > gt_boxes[..., 1, None]) & (ay < gt_boxes[..., 3, None])
    ) & gt_valid[..., None]                                       # (B, M, N)
    iou = plain_iou(pred_boxes, gt_boxes)                         # (B, M, N)
    cls_idx = gt_cls.long().clamp(0, C - 1)[..., None].expand(B, M, N)
    cls_score = torch.gather(pred_scores.transpose(1, 2), 1, cls_idx)  # (B, M, N)
    metric = torch.where(in_gt, cls_score ** TAL_ALPHA * iou ** TAL_BETA, 0.0)
    # top-k per GT, dense and masked; strictly positive metrics only: the
    # k-th value is 0 when a GT has fewer than k candidates
    k = min(TAL_TOPK, N)
    thresh = torch.topk(metric, k, dim=-1).values[..., -1:]       # (B, M, 1)
    is_topk = (metric >= thresh) & (metric > 0) & in_gt
    # an anchor claimed by several GTs goes to the highest IoU (the first on a tie)
    iou_masked = torch.where(is_topk, iou, -1.0)
    assigned_gt = torch.argmax(iou_masked, dim=1)                 # (B, N)
    pick = assigned_gt[:, None, :]
    best = torch.gather(iou_masked, 1, pick)[:, 0]
    fg = is_topk.any(dim=1) & (best >= 0)
    a_iou = torch.gather(iou, 1, pick)[:, 0]
    a_metric = torch.gather(metric, 1, pick)[:, 0]
    # norm_align_metric: per GT, the anchor of highest metric gets the GT's highest IoU
    gt_max_metric = torch.where(is_topk, metric, 0.0).amax(dim=-1)  # (B, M)
    gt_max_iou = torch.where(is_topk, iou, 0.0).amax(dim=-1)
    norm = gt_max_iou / gt_max_metric.clamp_min(1e-9)
    a_norm = torch.gather(norm, 1, assigned_gt)
    target_score = torch.where(fg, a_metric * a_norm, 0.0)
    return fg, assigned_gt, target_score, torch.where(fg, a_iou, 0.0)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _decode_dense(level_outputs, anchors, strides_per_anchor):
    """NCHW maps → (boxes (B, N, 4) pixels xyxy, cls_logits (B, N, C),
    dfl_logits (B, N, 4, REG_MAX)), the anchors row-major over each level's
    cells as in ``decode_predictions``; the training decode keeps logits."""
    regs, clss = [], []
    for reg, cls in level_outputs:
        B, _, H, W = reg.shape
        regs.append(reg.permute(0, 2, 3, 1).reshape(B, H * W, 4, REG_MAX))
        clss.append(cls.permute(0, 2, 3, 1).reshape(B, H * W, cls.shape[1]))
    dfl_logits = torch.cat(regs, dim=1)
    cls_logits = torch.cat(clss, dim=1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=dfl_logits.device)
    dist = (dfl_logits.softmax(dim=-1) * bins).sum(dim=-1)  # (B, N, 4)
    lt = anchors[None] - dist[..., :2] * strides_per_anchor[None, :, None]
    rb = anchors[None] + dist[..., 2:] * strides_per_anchor[None, :, None]
    return torch.cat([lt, rb], dim=-1), cls_logits, dfl_logits


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, elementwise."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits)


def detection_loss(
    params: Params,
    images: torch.Tensor,     # (B, 3, S, S) in [0, 1]
    gt_boxes: torch.Tensor,   # (B, M, 4) xyxy pixels (padded)
    gt_cls: torch.Tensor,     # (B, M) int
    gt_valid: torch.Tensor,   # (B, M) bool
    anchors: torch.Tensor,
    strides_per_anchor: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    boxes, cls_logits, dfl_logits = _decode_dense(forward(params, images), anchors, strides_per_anchor)
    probs = cls_logits.sigmoid()
    fg, a_gt, t_score, _ = assign_tal(boxes.detach(), probs.detach(), anchors, gt_boxes, gt_cls, gt_valid)
    B, N, C = cls_logits.shape
    a_boxes = torch.gather(gt_boxes, 1, a_gt[..., None].expand(B, N, 4))  # (B, N, 4)
    a_cls = torch.gather(gt_cls.long(), 1, a_gt)                            # (B, N)

    # cls: BCE with task-aligned soft targets, over the summed target scores
    targets = F.one_hot(a_cls, C).to(cls_logits.dtype) * t_score[..., None] * fg[..., None]
    norm = t_score.sum().clamp_min(1.0)
    loss_cls = _sigmoid_bce(cls_logits, targets).sum() / norm

    # box: CIoU on positives, weighted by the target score
    w = t_score * fg
    loss_box = ((1.0 - _diag_ciou(boxes, a_boxes)) * w).sum() / norm

    # dfl: ltrb distances in stride units against the adjacent-bin cross-entropy
    spa = strides_per_anchor[None, :, None]
    dist = torch.cat([(anchors[None] - a_boxes[..., :2]) / spa, (a_boxes[..., 2:] - anchors[None]) / spa], dim=-1)
    dist = dist.clamp(0.0, REG_MAX - 1 - 1e-3)  # (B, N, 4)
    lo = torch.floor(dist)
    hi = lo + 1
    wl = hi - dist
    logp = F.log_softmax(dfl_logits, dim=-1)  # (B, N, 4, REG_MAX)

    def at(idx):
        return torch.gather(logp, -1, idx.long()[..., None])[..., 0]

    ce = -(at(lo) * wl + at(hi.clamp_max(REG_MAX - 1)) * (1 - wl))
    loss_dfl = (ce.mean(dim=-1) * w).sum() / norm

    total = W_BOX * loss_box + W_CLS * loss_cls + W_DFL * loss_dfl
    aux = {"loss": total, "box": loss_box, "cls": loss_cls, "dfl": loss_dfl, "num_fg": fg.sum() / B}
    return total, aux


def _diag_ciou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Elementwise CIoU over matched (B, N, 4) prediction / GT pairs → (B, N)."""
    px1, py1, px2, py2 = pred.unbind(-1)
    gx1, gy1, gx2, gy2 = gt.unbind(-1)
    iw = (torch.minimum(px2, gx2) - torch.maximum(px1, gx1)).clamp_min(0)
    ih = (torch.minimum(py2, gy2) - torch.maximum(py1, gy1)).clamp_min(0)
    inter = iw * ih
    pa = (px2 - px1).clamp_min(0) * (py2 - py1).clamp_min(0)
    ga = (gx2 - gx1).clamp_min(0) * (gy2 - gy1).clamp_min(0)
    iou = inter / (pa + ga - inter).clamp_min(1e-9)
    cw = torch.maximum(px2, gx2) - torch.minimum(px1, gx1)
    ch = torch.maximum(py2, gy2) - torch.minimum(py1, gy1)
    c2 = cw ** 2 + ch ** 2 + 1e-9
    rho2 = ((px1 + px2 - gx1 - gx2) / 2) ** 2 + ((py1 + py2 - gy1 - gy2) / 2) ** 2
    pw, ph = (px2 - px1).clamp_min(1e-9), (py2 - py1).clamp_min(1e-9)
    gw, gh = (gx2 - gx1).clamp_min(1e-9), (gy2 - gy1).clamp_min(1e-9)
    v = (4 / math.pi ** 2) * (torch.atan(gw / gh) - torch.atan(pw / ph)) ** 2
    alpha = v / (1 - iou + v).clamp_min(1e-9)
    return iou - rho2 / c2 - alpha.detach() * v


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def init_detect_biases(params: Params, imgsz: int) -> Params:
    """Prior-bias init of the detect head (the ultralytics recipe): the reg
    branch's last bias 1.0; the cls branch's last bias log(5/nc/(imgsz/stride)²),
    a prior of ~5 objects an image. Without it the BCE over every
    anchor × class starts at ~0.7 and dominates early training."""
    for lv, stride in zip(params["head"]["levels"], STRIDES):
        nc = lv["cv3"][2]["bias"].shape[0]
        lv["cv2"][2]["bias"] = torch.ones_like(lv["cv2"][2]["bias"])
        lv["cv3"][2]["bias"] = torch.full_like(lv["cv3"][2]["bias"], math.log(5 / nc / (imgsz / stride) ** 2))
    return params


@dataclass
class YoloTrainState:
    """``params``: the fp32 tree on the training device; ``opt_state``: the
    optimizer's; ``step``: steps so far. A step returns a new state."""

    params: Params
    opt_state: Any
    step: int


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def make_yolo_train_step(
    imgsz: int, tx, device: str | torch.device = "cuda"
) -> Callable[[YoloTrainState, dict], tuple[YoloTrainState, dict]]:
    """``step(state, batch) -> (state, aux)``: the detection loss at fp32,
    its gradients by autograd, ``tx``'s update. ``batch`` holds the
    ``DetectDataset`` arrays (uint8 NHWC images); ``aux`` holds 0-dim device
    tensors (loss, box, cls, dfl, num_fg, grad_norm): nothing waits for the
    device."""
    dev = resolve_device(device)
    anchors, strides_pa = make_anchors(imgsz, device=dev)
    scale = torch.full((), 255.0, device=dev)  # a true division on every device

    def step(state: YoloTrainState, batch: dict) -> tuple[YoloTrainState, dict]:
        b = batch_to_device(batch, dev)
        images = (b["images"].to(torch.float32) / scale).permute(0, 3, 1, 2).contiguous()
        live = [t.detach().requires_grad_(True) for _, t in tree_leaves(state.params)]
        params = _rebuild(state.params, iter(live))
        loss, aux = detection_loss(params, images, b["boxes"], b["classes"], b["valid"], anchors, strides_pa)
        grads = _rebuild(state.params, iter(torch.autograd.grad(loss, live)))
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new = YoloTrainState(apply_updates(state.params, updates), opt_state, state.step + 1)
        aux = {k: v.detach() for k, v in aux.items()}
        return new, {**aux, "grad_norm": global_norm(grads)}

    return step


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def load_detect_csv(csv_path: str, max_boxes: int = 4):
    """boxes_{split}.csv → (paths, boxes (n, M, 4) f32, cls (n, M) i32,
    valid (n, M) bool)."""
    import csv as _csv

    paths, boxes, cls, valid = [], [], [], []
    with open(csv_path) as f:
        for row in _csv.DictReader(f):
            entries = [e for e in row["boxes"].split(";") if e.strip()]
            b = np.zeros((max_boxes, 4), np.float32)
            c = np.zeros((max_boxes,), np.int32)
            v = np.zeros((max_boxes,), bool)
            for i, e in enumerate(entries[:max_boxes]):
                x1, y1, x2, y2, k = e.split()
                b[i] = [float(x1), float(y1), float(x2), float(y2)]
                c[i] = int(k)
                v[i] = True
            paths.append(row["image_path"])
            boxes.append(b)
            cls.append(c)
            valid.append(v)
    return paths, np.stack(boxes), np.stack(cls), np.stack(valid)


class DetectDataset:
    """The whole corpus in host memory (uint8), with hflip augmentation: at
    320² the 3k-image corpus is under 1 GB, and decoding it once keeps the
    host from starving the device."""

    def __init__(self, csv_path: str, imgsz: int, max_boxes: int = 4):
        from PIL import Image

        self.imgsz = imgsz
        self.paths, self.boxes, self.cls, self.valid = load_detect_csv(csv_path, max_boxes)
        imgs = []
        for p in self.paths:
            im = Image.open(p).convert("RGB")
            if im.size != (imgsz, imgsz):
                im = im.resize((imgsz, imgsz), Image.Resampling.BILINEAR)
            imgs.append(np.asarray(im, np.uint8))
        self.images = np.stack(imgs)

    def __len__(self):
        return len(self.paths)

    def batches(self, batch_size: int, rng: np.random.Generator, hflip_p: float = 0.5) -> Iterator[dict]:
        """One epoch of shuffled, static-shape batches (drop-last); the draws
        from ``rng`` are the JAX package's, so one seed gives its batches."""
        order = rng.permutation(len(self.paths))
        S = self.imgsz
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            imgs = self.images[idx].copy()
            boxes = self.boxes[idx].copy()
            flip = rng.random(batch_size) < hflip_p
            imgs[flip] = imgs[flip, :, ::-1]
            x1 = boxes[flip, :, 0].copy()
            boxes[flip, :, 0] = S - boxes[flip, :, 2]
            boxes[flip, :, 2] = S - x1
            yield {"images": imgs, "boxes": boxes, "classes": self.cls[idx], "valid": self.valid[idx]}
