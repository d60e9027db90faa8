"""Host-side image preprocessing: decode → resize → center-crop → normalize.

PyTorch port's copy of ``clip_lora_match_tpu/preprocess/image.py``: the PIL
pipeline (and the PIL rows of ``data/native_loader.py``).

From-scratch replacement for the reference's ``CLIPProcessor`` image path
(ref:src/preprocessing/clip_preprocess.py:35-44). Semantics match the CLIP
image pipeline exactly (validated against HF ``CLIPImageProcessor`` goldens):

1. convert to RGB;
2. resize so the SHORTEST edge equals ``image_size`` (bicubic);
3. center-crop to ``image_size`` × ``image_size``;
4. scale to [0,1] and normalize with the CLIP mean/std constants
   (ref:config/clip_config.yaml preprocess.normalize).

Output layout is NHWC, the layout ``models/clip._patchify`` takes, unlike the
reference's NCHW.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image

from clip_lora_match_tpu_torch.core.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, PreprocessConfig


def _resize_shortest(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    if short == size:
        return img
    # Truncating (not rounding) the long edge matches the canonical CLIP
    # resize — off-by-one here shifts the center crop and breaks pixel parity.
    new_short, new_long = size, max(size, int(long * size / short))
    nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
    return img.resize((nw, nh), Image.Resampling.BICUBIC)


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def preprocess_pil(
    img: Image.Image,
    image_size: int = 224,
    mean: Sequence[float] = CLIP_IMAGE_MEAN,
    std: Sequence[float] = CLIP_IMAGE_STD,
    center_crop: bool = True,
) -> np.ndarray:
    """PIL image → (H, W, 3) float32 normalized array."""
    img = img.convert("RGB")
    img = _resize_shortest(img, image_size)
    if center_crop:
        img = _center_crop(img, image_size)
    else:
        img = img.resize((image_size, image_size), Image.Resampling.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - np.asarray(mean, dtype=np.float32)) / np.asarray(std, dtype=np.float32)
    return arr


def preprocess_image(
    path_or_img: str | Image.Image,
    cfg: PreprocessConfig | None = None,
) -> np.ndarray:
    """File path or PIL image → (H, W, 3) float32 normalized array."""
    cfg = cfg or PreprocessConfig()
    img = Image.open(path_or_img) if isinstance(path_or_img, str) else path_or_img
    return preprocess_pil(
        img,
        image_size=cfg.image_size,
        mean=cfg.mean,
        std=cfg.std,
        center_crop=cfg.center_crop,
    )


def load_resized_cropped_u8(
    path_or_img: str | Image.Image,
    cfg: PreprocessConfig | None = None,
) -> np.ndarray:
    """File path or PIL image → (S, S, 3) uint8 RGB, resized and center-cropped
    but not normalized: the uint8 feed's PIL row (normalized on the device)."""
    cfg = cfg or PreprocessConfig()
    img = Image.open(path_or_img) if isinstance(path_or_img, str) else path_or_img
    img = img.convert("RGB")
    img = _resize_shortest(img, cfg.image_size)
    if cfg.center_crop:
        img = _center_crop(img, cfg.image_size)
    else:
        img = img.resize((cfg.image_size, cfg.image_size), Image.Resampling.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def preprocess_image_batch(
    items: Sequence[str | Image.Image],
    cfg: PreprocessConfig | None = None,
) -> np.ndarray:
    """Batch of paths/images → (B, H, W, 3) float32. Empty input → (0, H, W, 3)
    (empty-batch tolerance mirrors ref:src/embedding/embed_image.py:95-96)."""
    cfg = cfg or PreprocessConfig()
    if not items:
        return np.zeros((0, cfg.image_size, cfg.image_size, 3), dtype=np.float32)
    return np.stack([preprocess_image(x, cfg) for x in items])


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, -1, -3)


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, -3, -1)
