"""YOLOv8 detector in PyTorch (port of ``models/yolo/yolov8.py``).

The published YOLOv8 architecture, written for the -s scale (``WIDTHS``, 80
classes, 640²) and read from the parameter tree, so the committed -n
checkpoints (``WIDTHS_N``, 320²) run through the same functions:

- backbone: Conv(s2) → Conv(s2) → C2f ×{1,2,2,1} over P2..P5 → SPPF;
- neck: top-down + bottom-up PAN with C2f fusion blocks;
- head: anchor-free decoupled reg (DFL, 16 bins) / cls branches at strides
  8/16/32;
- decode: DFL softmax expectation → ltrb distances from anchors at cell
  centres; NMS: ``postprocess.nms_fixed``.

BatchNorm is folded into the conv weights (an inference-only detector). The
port computes NCHW (``channels_last`` on CUDA, where cuDNN's tensor-core
convolutions want it); the convolutions are ``torch.nn.functional.conv2d``,
as the JAX package leaves its convolutions to XLA. The weight files are the
JAX package's: a flat ``.npz`` tree with HWIO kernels, or an ultralytics
state dict. ``params_from_jax`` is the one place that turns HWIO into OIHW,
and ``params_to_jax`` the one that turns it back (the trainer's saves).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from clip_lora_match_tpu_torch.core.config import YoloConfig
from clip_lora_match_tpu_torch.core.device import resolve_device
from clip_lora_match_tpu_torch.models.io import to_device, tree_map, unflatten
from clip_lora_match_tpu_torch.models.yolo.cropper import Detection
from clip_lora_match_tpu_torch.models.yolo.postprocess import nms_fixed

Params = dict[str, Any]

# YOLOv8-s geometry
WIDTHS = {"P1": 32, "P2": 64, "P3": 128, "P4": 256, "P5": 512}
DEPTHS = {"c2f_2": 1, "c2f_4": 2, "c2f_6": 2, "c2f_8": 1, "neck": 1}
REG_MAX = 16
NUM_CLASSES = 80
STRIDES = (8, 16, 32)
# the -n scale (width 0.25 against -s 0.50), same depths: the committed
# synthetic-corpus and real-photo checkpoints
WIDTHS_N = {"P1": 16, "P2": 32, "P3": 64, "P4": 128, "P5": 256}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def conv(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Conv (+ folded BN) + SiLU; kernel (cout, cin, kh, kw), NCHW."""
    return F.silu(conv_plain(p, x, stride))


def conv_plain(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Conv + bias, no activation (the detect head's last layers)."""
    k = p["kernel"]
    return F.conv2d(x, k.to(x.dtype), p["bias"].to(x.dtype), stride=stride, padding=k.shape[-1] // 2)


def bottleneck(p: Params, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
    y = conv(p["cv2"], conv(p["cv1"], x))
    return x + y if shortcut else y


def c2f(p: Params, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
    """Cross-stage partial with n bottlenecks: cv1's output split in two along
    the channels, every intermediate concatenated in order."""
    outs = list(conv(p["cv1"], x).chunk(2, dim=1))
    for bp in p["m"]:
        outs.append(bottleneck(bp, outs[-1], shortcut))
    return conv(p["cv2"], torch.cat(outs, dim=1))


def sppf(p: Params, x: torch.Tensor, k: int = 5) -> torch.Tensor:
    y = conv(p["cv1"], x)
    p1 = F.max_pool2d(y, k, 1, k // 2)  # -inf padding, as reduce_window's
    p2 = F.max_pool2d(p1, k, 1, k // 2)
    p3 = F.max_pool2d(p2, k, 1, k // 2)
    return conv(p["cv2"], torch.cat([y, p1, p2, p3], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def detect_head(p: Params, feats: Sequence[torch.Tensor]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per level: (reg (B, 4*REG_MAX, H, W), cls (B, NC, H, W)) raw maps."""
    outs = []
    for level, x in zip(p["levels"], feats):
        cv2, cv3 = level["cv2"], level["cv3"]
        reg = conv_plain(cv2[2], conv(cv2[1], conv(cv2[0], x)))
        cls = conv_plain(cv3[2], conv(cv3[1], conv(cv3[0], x)))
        outs.append((reg, cls))
    return outs


def forward(params: Params, images: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(B, 3, H, W) in [0, 1] → per-level (reg, cls) raw maps, NCHW."""
    b = params["backbone"]
    x = conv(b["0"], images, 2)            # P1/2
    x = conv(b["1"], x, 2)                 # P2/4
    x = c2f(b["2"], x, True)
    x = conv(b["3"], x, 2)                 # P3/8
    p3 = c2f(b["4"], x, True)
    x = conv(b["5"], p3, 2)                # P4/16
    p4 = c2f(b["6"], x, True)
    x = conv(b["7"], p4, 2)                # P5/32
    x = c2f(b["8"], x, True)
    p5 = sppf(b["9"], x)

    n = params["neck"]
    t4 = c2f(n["12"], torch.cat([upsample2x(p5), p4], dim=1), False)
    t3 = c2f(n["15"], torch.cat([upsample2x(t4), p3], dim=1), False)  # stride 8
    o4 = c2f(n["18"], torch.cat([conv(n["16"], t3, 2), t4], dim=1), False)  # stride 16
    o5 = c2f(n["21"], torch.cat([conv(n["19"], o4, 2), p5], dim=1), False)  # stride 32
    return detect_head(params["head"], (t3, o4, o5))


def decode_predictions(
    level_outputs: Sequence[tuple[torch.Tensor, torch.Tensor]],
    strides: Sequence[int] = STRIDES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw maps → (boxes (B, N, 4) xyxy in input pixels, cls_probs (B, N, NC)),
    in fp32 whatever the maps' type. Anchors run over the cells in row-major
    (y, x) order, as in the JAX package's NHWC maps."""
    all_boxes, all_probs = [], []
    for (reg, cls), stride in zip(level_outputs, strides):
        B, _, H, W = reg.shape
        dev = reg.device
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
        dist = reg.float().permute(0, 2, 3, 1).reshape(B, H * W, 4, REG_MAX)
        dist = (dist.softmax(dim=-1) * bins).sum(dim=-1)  # (B, HW, 4) ltrb
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij",
        )
        anchors = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # (HW, 2)
        x1y1 = (anchors[None] - dist[..., :2]) * stride
        x2y2 = (anchors[None] + dist[..., 2:]) * stride
        all_boxes.append(torch.cat([x1y1, x2y2], dim=-1))
        all_probs.append(cls.float().permute(0, 2, 3, 1).reshape(B, H * W, -1).sigmoid())
    return torch.cat(all_boxes, dim=1), torch.cat(all_probs, dim=1)


# ---------------------------------------------------------------------------
# Parameters: the weight bridge, initialization, ultralytics conversion
# ---------------------------------------------------------------------------

_LIST_KEYS = ("m", "levels", "cv2", "cv3")


def _lists(tree, key: str = ""):
    """The JAX file layout stores lists under numbered keys; give the list
    nodes (c2f ``m``, head ``levels`` and its ``cv2``/``cv3``) back as lists."""
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if key in _LIST_KEYS and tree and all(k.isdigit() for k in tree):
        return [_lists(tree[k]) for k in sorted(tree, key=int)]
    return {k: _lists(v, k) for k, v in tree.items()}


def params_from_jax(tree: Params, device: str | torch.device = "cuda") -> Params:
    """A parameter tree in the JAX package's layout (numpy or JAX arrays,
    kernels (kh, kw, cin, cout)) → fp32 torch tree on ``device``, kernels
    (cout, cin, kh, kw)."""
    dev = resolve_device(device)

    def leaf(x):
        a = np.asarray(x, np.float32)
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a

    return to_device(tree_map(leaf, _lists(tree)), dev, torch.float32)


def params_to_jax(params: Params, dtype=np.float32) -> Params:
    """The inverse of ``params_from_jax``: a torch tree → a numpy tree in the
    JAX package's layout (kernels (kh, kw, cin, cout), lists kept), leaves
    cast to ``dtype``; ``models.io.save_params`` writes it as the JAX
    trainer writes its weights."""

    def leaf(t):
        a = t.detach().float().cpu().numpy()
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a).astype(dtype)

    return tree_map(leaf, params)


def _init_conv(rng, kh, cin, cout):
    bound = 1.0 / np.sqrt(kh * kh * cin)
    return {
        "kernel": rng.uniform(-bound, bound, (kh, kh, cin, cout)).astype(np.float32),
        "bias": np.zeros((cout,), np.float32),
    }


def _init_c2f(rng, cin, cout, n):
    half = cout // 2
    return {
        "cv1": _init_conv(rng, 1, cin, cout),
        "m": [{"cv1": _init_conv(rng, 3, half, half), "cv2": _init_conv(rng, 3, half, half)}
              for _ in range(n)],
        "cv2": _init_conv(rng, 1, (2 + n) * half, cout),
    }


def init_params(
    seed: int = 0,
    widths: Optional[dict] = None,
    depths: Optional[dict] = None,
    num_classes: int = NUM_CLASSES,
    device: str | torch.device = "cuda",
) -> Params:
    """Random-init YOLOv8 tree (numpy from ``seed``, so every device gets the
    same weights). Defaults to the -s plan; ``widths=WIDTHS_N`` and
    ``num_classes=10`` give the synthetic-corpus variant. The values are not
    the JAX package's (another generator); the shapes are."""
    rng = np.random.default_rng(seed)
    W = dict(widths or WIDTHS)
    D = dict(depths or DEPTHS)
    backbone = {
        "0": _init_conv(rng, 3, 3, W["P1"]),
        "1": _init_conv(rng, 3, W["P1"], W["P2"]),
        "2": _init_c2f(rng, W["P2"], W["P2"], D["c2f_2"]),
        "3": _init_conv(rng, 3, W["P2"], W["P3"]),
        "4": _init_c2f(rng, W["P3"], W["P3"], D["c2f_4"]),
        "5": _init_conv(rng, 3, W["P3"], W["P4"]),
        "6": _init_c2f(rng, W["P4"], W["P4"], D["c2f_6"]),
        "7": _init_conv(rng, 3, W["P4"], W["P5"]),
        "8": _init_c2f(rng, W["P5"], W["P5"], D["c2f_8"]),
        "9": {
            "cv1": _init_conv(rng, 1, W["P5"], W["P5"] // 2),
            "cv2": _init_conv(rng, 1, W["P5"] * 2, W["P5"]),
        },
    }
    neck = {
        "12": _init_c2f(rng, W["P5"] + W["P4"], W["P4"], D["neck"]),
        "15": _init_c2f(rng, W["P4"] + W["P3"], W["P3"], D["neck"]),
        "16": _init_conv(rng, 3, W["P3"], W["P3"]),
        "18": _init_c2f(rng, W["P3"] + W["P4"], W["P4"], D["neck"]),
        "19": _init_conv(rng, 3, W["P4"], W["P4"]),
        "21": _init_c2f(rng, W["P4"] + W["P5"], W["P5"], D["neck"]),
    }
    # head channel plan (ultralytics Detect):
    # c2 = max(16, ch0 // 4, 4 * REG_MAX); c3 = max(ch0, min(nc, 100))
    c2 = max(16, W["P3"] // 4, 4 * REG_MAX)
    c3 = max(W["P3"], min(num_classes, 100))
    levels = [
        {
            "cv2": [_init_conv(rng, 3, ch, c2), _init_conv(rng, 3, c2, c2),
                    _init_conv(rng, 1, c2, 4 * REG_MAX)],
            "cv3": [_init_conv(rng, 3, ch, c3), _init_conv(rng, 3, c3, c3),
                    _init_conv(rng, 1, c3, num_classes)],
        }
        for ch in (W["P3"], W["P4"], W["P5"])
    ]
    tree = {"backbone": backbone, "neck": neck, "head": {"levels": levels}}
    return params_from_jax(tree, device)


def _fold_bn(conv_w, gamma, beta, mean, var, eps=1e-3):
    """Conv (no bias) + BN → fused kernel and bias. conv_w torch layout
    (cout, cin, kh, kw) → (kh, kw, cin, cout), the file layout."""
    scale = gamma / np.sqrt(var + eps)
    w = conv_w * scale[:, None, None, None]
    bias = beta - mean * scale
    return np.transpose(w, (2, 3, 1, 0)), bias


def convert_ultralytics_state_dict(sd: dict) -> Params:
    """Flat ultralytics ``model.{i}...`` arrays → the parameter tree in the
    file layout (numpy, HWIO kernels), as the JAX package builds it; the
    detect head's last convs (no BN) pass through."""
    sd = {k.replace("model.model.", "model."): np.asarray(v) for k, v in sd.items()}

    def fused(prefix):
        return dict(zip(("kernel", "bias"), _fold_bn(
            sd[f"{prefix}.conv.weight"], sd[f"{prefix}.bn.weight"], sd[f"{prefix}.bn.bias"],
            sd[f"{prefix}.bn.running_mean"], sd[f"{prefix}.bn.running_var"],
        )))

    def plain(prefix):
        w = sd[f"{prefix}.weight"]
        return {
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "bias": sd.get(f"{prefix}.bias", np.zeros(w.shape[0], np.float32)),
        }

    def c2f_block(i, n):
        return {
            "cv1": fused(f"model.{i}.cv1"),
            "cv2": fused(f"model.{i}.cv2"),
            "m": [{"cv1": fused(f"model.{i}.m.{j}.cv1"), "cv2": fused(f"model.{i}.m.{j}.cv2")}
                  for j in range(n)],
        }

    backbone = {
        "0": fused("model.0"),
        "1": fused("model.1"),
        "2": c2f_block(2, DEPTHS["c2f_2"]),
        "3": fused("model.3"),
        "4": c2f_block(4, DEPTHS["c2f_4"]),
        "5": fused("model.5"),
        "6": c2f_block(6, DEPTHS["c2f_6"]),
        "7": fused("model.7"),
        "8": c2f_block(8, DEPTHS["c2f_8"]),
        "9": {"cv1": fused("model.9.cv1"), "cv2": fused("model.9.cv2")},
    }
    neck = {
        "12": c2f_block(12, DEPTHS["neck"]),
        "15": c2f_block(15, DEPTHS["neck"]),
        "16": fused("model.16"),
        "18": c2f_block(18, DEPTHS["neck"]),
        "19": fused("model.19"),
        "21": c2f_block(21, DEPTHS["neck"]),
    }
    levels = [
        {
            "cv2": [fused(f"model.22.cv2.{lv}.0"), fused(f"model.22.cv2.{lv}.1"),
                    plain(f"model.22.cv2.{lv}.2")],
            "cv3": [fused(f"model.22.cv3.{lv}.0"), fused(f"model.22.cv3.{lv}.1"),
                    plain(f"model.22.cv3.{lv}.2")],
        }
        for lv in range(3)
    ]
    return {"backbone": backbone, "neck": neck, "head": {"levels": levels}}


# ---------------------------------------------------------------------------
# Detector: host letterbox, device inference and NMS
# ---------------------------------------------------------------------------


def letterbox(img: Image.Image, size: int = 640) -> tuple[np.ndarray, float, tuple[int, int]]:
    """Aspect-preserving resize onto a (size, size) gray canvas.
    Returns (array (size, size, 3) in [0, 1], scale, (pad_x, pad_y))."""
    w, h = img.size
    scale = min(size / w, size / h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    resized = img.resize((nw, nh), Image.Resampling.BILINEAR)
    canvas = Image.new("RGB", (size, size), (114, 114, 114))
    px, py = (size - nw) // 2, (size - nh) // 2
    canvas.paste(resized, (px, py))
    arr = np.asarray(canvas, dtype=np.float32) / 255.0
    return arr, scale, (px, py)


class YoloV8Detector:
    """Detector-protocol implementation on ``device`` (default ``"cuda"``).

    ``compute_dtype``: the conv stack's type; bf16 on CUDA and fp32 on the CPU
    unless given (``torch.float32``, ``torch.bfloat16`` or their names). The
    decode and NMS run in fp32 either way."""

    def __init__(
        self,
        params: Params,
        cfg: Optional[YoloConfig] = None,
        compute_dtype=None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or YoloConfig()
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = _DTYPES.get(compute_dtype, compute_dtype)
        self.params = to_device(params, self.device, torch.float32)
        self._channels_last = self.device.type == "cuda"

        def serving(t):
            t = t.to(self.compute_dtype)
            return t.contiguous(memory_format=torch.channels_last) if self._channels_last and t.ndim == 4 else t

        self._params_c = tree_map(serving, self.params)

    @torch.inference_mode()
    def infer(self, images: torch.Tensor, conf: float, iou: float, max_det: int, agnostic: bool = False):
        """Letterboxed batch (B, 3, S, S) in [0, 1] → ``nms_fixed``'s four
        tensors, with a leading batch axis, on the detector's device."""
        x = images.to(self.device, self.compute_dtype)
        if self._channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        boxes, probs = decode_predictions(forward(self._params_c, x))
        return nms_fixed(boxes, probs.amax(-1), probs.argmax(-1), conf, iou, max_det=max_det, agnostic=agnostic)

    def detect(
        self, image: Image.Image, conf: float, iou: float, max_det: int,
        classes=None, agnostic: bool = False,
    ) -> list[Detection]:
        size = self.cfg.imgsz
        arr, scale, (px, py) = letterbox(image, size)
        x = torch.from_numpy(arr).permute(2, 0, 1)[None]
        boxes, scores, cls_ids, valid = (t[0].cpu().numpy() for t in self.infer(x, conf, iou, max_det, agnostic))
        w, h = image.size
        out = []
        for b, s, c, v in zip(boxes, scores, cls_ids, valid):
            if not v:
                continue
            if classes is not None and int(c) not in classes:
                continue
            x1, y1 = max(0.0, (b[0] - px) / scale), max(0.0, (b[1] - py) / scale)
            x2, y2 = min(float(w), (b[2] - px) / scale), min(float(h), (b[3] - py) / scale)
            if x2 > x1 and y2 > y1:
                out.append(Detection((float(x1), float(y1), float(x2), float(y2)), float(s), int(c)))
        return out


def read_detector(weights_path: str, cfg: Optional[YoloConfig] = None):
    """The host half of ``load_detector``: read and parse the ``.npz`` (an
    ultralytics state dict or a native tree) and apply a ``meta.json``
    beside it → (numpy parameter tree, config)."""
    with np.load(weights_path) as data:
        flat = {k: np.asarray(data[k], np.float32) for k in data.files}
    if any(k.startswith("model.") for k in flat):
        tree = convert_ultralytics_state_dict(flat)
    else:
        tree = unflatten(flat)
    meta = os.path.join(os.path.dirname(weights_path), "meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            imgsz = json.load(f).get("imgsz")
        if imgsz:
            cfg = dataclasses.replace(cfg or YoloConfig(), imgsz=int(imgsz))
    return tree, cfg


def load_detector(
    weights_path: str,
    cfg: Optional[YoloConfig] = None,
    device: str | torch.device = "cuda",
    compute_dtype=None,
) -> YoloV8Detector:
    """Load an ``.npz`` of ultralytics state-dict arrays or a native parameter
    tree (the JAX package's file layout; fp16 storage is computed in fp32).
    A ``meta.json`` beside the weights overrides the config's ``imgsz``, so
    inference letterboxes to the trained resolution."""
    dev = resolve_device(device)
    tree, cfg = read_detector(weights_path, cfg)
    return YoloV8Detector(params_from_jax(tree, dev), cfg, compute_dtype=compute_dtype, device=dev)
