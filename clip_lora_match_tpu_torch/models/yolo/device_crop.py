"""Device-side batched crop + resize: detector boxes straight to CLIP input
(port of ``models/yolo/device_crop.py``).

Images stay on the device: each box is cropped and resampled to the CLIP
input size, then CLIP-normalized. The resampling is JAX's
``jax.image.scale_and_translate`` (``method="cubic"``, ``antialias=True``) and
``jax.image.resize(..., "bilinear")``, written out here: per axis, a weight
matrix of the Keys cubic (a = -0.5) or the triangle kernel, widened by the
inverse scale when it downsamples, renormalized per output sample, and zero
for samples outside the input; the image is then two batched products with
those matrices. ``F.interpolate`` would resample differently (a = -0.75,
other edge rules, no widening).

The file-writing cropper (``models/yolo/cropper.py``) stays the
behaviour-parity path; ``crop_embed_pipeline`` is the seeker's device path
and ``make_fused_search`` the whole query (detect → crop → embed → top-k) on
the device with one readback.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from clip_lora_match_tpu_torch.core.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

_EPS32 = float(np.finfo(np.float32).eps)


def _device_vector(values, device) -> torch.Tensor:
    """A small fp32 vector made on ``device`` from fills: no host-to-device
    copy (``torch.tensor(..., device=)`` and item assignment both copy from
    the host and synchronize)."""
    return torch.stack([torch.full((), float(x), dtype=torch.float32, device=device) for x in values])


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


def weight_mat(
    input_size: int, output_size: int, inv_scale: torch.Tensor, offset: torch.Tensor, kernel, antialias: bool
) -> torch.Tensor:
    """JAX's ``compute_weight_mat`` over a batch: ``inv_scale`` (B,) is 1 /
    scale and ``offset`` (B,) is translation · inv_scale, both fp32 →
    weights (B, input_size, output_size)."""
    dev = inv_scale.device
    kernel_scale = inv_scale.clamp_min(1.0) if antialias else torch.ones_like(inv_scale)
    out_pos = torch.arange(output_size, dtype=torch.float32, device=dev) + 0.5
    sample_f = out_pos[None] * inv_scale[:, None] - offset[:, None] - 0.5  # (B, out)
    in_pos = torch.arange(input_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs() / kernel_scale[:, None, None]
    w = kernel(x)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * _EPS32, w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def crop_resize_batch(
    images: torch.Tensor, boxes: torch.Tensor, out_size: int = 224, antialias: bool = True
) -> torch.Tensor:
    """Crop each image to its box and resize to (out_size, out_size).

    images (B, H, W, 3) float in [0, 1]; boxes (B, 4) xyxy in pixels →
    (B, out_size, out_size, 3) fp32. The output grid maps onto the box:
    scale = out / box extent, translation = -x1 · scale."""
    B, H, W, C = images.shape
    images = images.float()
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    bw = (x2 - x1).clamp_min(1.0)
    bh = (y2 - y1).clamp_min(1.0)
    inv_y = 1.0 / (out_size / bh)
    inv_x = 1.0 / (out_size / bw)
    wy = weight_mat(H, out_size, inv_y, (-y1 * out_size / bh) * inv_y, _keys_cubic, antialias)
    wx = weight_mat(W, out_size, inv_x, (-x1 * out_size / bw) * inv_x, _keys_cubic, antialias)
    rows = torch.einsum("bhi,bhwc->biwc", wy, images)
    return torch.einsum("bwj,biwc->bijc", wx, rows)


def crop_resize_normalize(images: torch.Tensor, boxes: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """``crop_resize_batch`` + CLIP mean/std normalization (encoder-ready)."""
    crops = crop_resize_batch(images, boxes, out_size=out_size)
    mean = _device_vector(CLIP_IMAGE_MEAN, crops.device)
    std = _device_vector(CLIP_IMAGE_STD, crops.device)
    return (crops.clamp(0.0, 1.0) - mean) / std


def resize_bilinear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``jax.image.resize(img, (nh, nw, C), "bilinear")`` (antialiased) for an
    (H, W, C) image; an axis whose size does not change is left as it is."""
    H, W, _ = img.shape
    img = img.float()
    dev = img.device
    zero = torch.zeros(1, device=dev)
    if nh != H:  # 1 / (nh / H) in float64, rounded once, as JAX computes it
        inv = torch.full((1,), 1.0 / (nh / H), dtype=torch.float32, device=dev)
        img = torch.einsum("hi,hwc->iwc", weight_mat(H, nh, inv, zero, _triangle, True)[0], img)
    if nw != W:
        inv = torch.full((1,), 1.0 / (nw / W), dtype=torch.float32, device=dev)
        img = torch.einsum("wj,iwc->ijc", weight_mat(W, nw, inv, zero, _triangle, True)[0], img)
    return img


def make_fused_search(detector, encoder, index, k: int = 5, conf: float = 0.25, iou: float = 0.45):
    """The whole image query on the detector's device: letterbox → detect →
    NMS → crop the best box (the full image when nothing is detected, chosen
    with ``torch.where``) → CLIP image tower → ``topk_retrieve_auto``. The
    upload is a pinned copy on CUDA and the only readback is one packed copy
    at the end. Semantics are the staged path's: the highest-scoring box,
    letterbox geometry as ``yolov8.letterbox``.

    Returns ``search(image_u8: (H, W, 3) uint8 array) -> (scores (k,), ids
    (k,), box_xyxy (4,), detected: bool)``."""
    from clip_lora_match_tpu_torch.models import clip as clip_model
    from clip_lora_match_tpu_torch.ops.retrieval_topk import topk_retrieve_auto

    dev = detector.device
    det_size = detector.cfg.imgsz
    arch = encoder.arch
    index = torch.as_tensor(index).to(dev)

    @torch.inference_mode()
    def search(image_u8: np.ndarray):
        H, W = int(image_u8.shape[0]), int(image_u8.shape[1])
        host = torch.from_numpy(np.array(image_u8, np.uint8, order="C"))  # a writable copy
        if dev.type == "cuda":
            host = host.pin_memory()
        img = host.to(dev, non_blocking=True).float() / 255.0  # (H, W, 3)
        # device letterbox, geometry as yolov8.letterbox
        scale = min(det_size / W, det_size / H)
        nw, nh = int(round(W * scale)), int(round(H * scale))
        px, py = (det_size - nw) // 2, (det_size - nh) // 2
        canvas = torch.full((det_size, det_size, 3), 114.0 / 255.0, device=dev)
        canvas[py:py + nh, px:px + nw] = resize_bilinear(img, nh, nw)
        b, _, _, valid = detector.infer(canvas.permute(2, 0, 1)[None], conf, iou, detector.cfg.max_det)
        detected = valid[0, 0]
        # best box back to image coordinates, clamped; the full image on none
        pad = _device_vector((px, py, px, py), dev)
        lim = _device_vector((W, H, W, H), dev)
        full = _device_vector((0.0, 0.0, W, H), dev)
        bb = torch.minimum(((b[0, 0] - pad) / scale).clamp_min(0.0), lim)
        bb = torch.where(detected, bb, full)
        pix = crop_resize_normalize(img[None], bb[None], out_size=arch.image_size)
        params, lora = encoder._serving_state()
        with encoder._dispatch():
            feats = clip_model.encode_image_features(
                params, pix, arch, lora=lora, lora_scaling=encoder.lora_scaling,
                compute_dtype=encoder.compute_dtype,
            )
        q = clip_model.l2_normalize(feats).float()
        top_s, top_i = topk_retrieve_auto(q, index, k)
        n = top_s.shape[1]
        packed = torch.cat([top_s[0].double(), top_i[0].double(), bb.double(), detected.double()[None]])
        out = packed.cpu().numpy()
        return (
            out[:n].astype(np.float32), out[n:2 * n].astype(np.int64),
            out[2 * n:2 * n + 4].astype(np.float32), bool(out[-1]),
        )

    return search


def crop_embed_pipeline(detector, encoder, image: Image.Image, k_best: int = 1, conf: float = 0.25,
                        iou: float = 0.45):
    """Two-stage serving path: detect → device crop → CLIP embed.

    image: PIL image. Returns (embeddings (n, D), detections) with n =
    min(k_best, detections), or one full-image embedding (the host
    preprocessing's) and [] when nothing is detected."""
    from clip_lora_match_tpu_torch.preprocess.image import preprocess_pil

    dets = detector.detect(image, conf=conf, iou=iou, max_det=max(k_best, 1))
    if not dets:
        pix = preprocess_pil(image, image_size=encoder.arch.image_size)
        return encoder.encode_image_batch(pix[None]), []
    dets = dets[:k_best]
    raw = torch.from_numpy(np.asarray(image.convert("RGB"), np.float32)[None] / 255.0)
    boxes = torch.tensor([d.box for d in dets], dtype=torch.float32)
    dev = encoder.device
    imgs = raw.to(dev).expand(len(dets), -1, -1, -1)
    pix = crop_resize_normalize(imgs, boxes.to(dev), out_size=encoder.arch.image_size)
    return encoder.encode_image_batch(pix), dets
