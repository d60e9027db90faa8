"""Unified image+text preprocessor (port of
``clip_lora_match_tpu/preprocess/pipeline.py``).

A batch made only of paths goes through the native JPEG loader
(``data/native_loader.py``) when its library builds, with PIL rows for what
it cannot decode; every other batch goes through the PIL pipeline in
``preprocess/image.py``. Text goes through the BPE tokenizer, padded to 77.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image

from clip_lora_match_tpu_torch.core.config import ClipConfig, load_clip_config
from clip_lora_match_tpu_torch.preprocess.image import preprocess_image, preprocess_image_batch
from clip_lora_match_tpu_torch.tokenizer.bpe import ClipTokenizer


class ClipPreprocessor:
    """Image+text preprocessing front-end for the CLIP encoders."""

    def __init__(
        self,
        config_path: Optional[str] = None,
        config: Optional[ClipConfig] = None,
        tokenizer: Optional[ClipTokenizer] = None,
    ):
        self.cfg = config or load_clip_config(config_path)
        self.pre = self.cfg.preprocess
        self.tokenizer = tokenizer or ClipTokenizer.from_dir(
            self.cfg.tokenizer_dir, max_length=self.pre.max_text_length
        )

    def preprocess_image(self, img: str | Image.Image) -> np.ndarray:
        """→ (1, H, W, 3) float32, a batch of one."""
        return preprocess_image(img, self.pre)[None]

    def preprocess_images(self, imgs: Sequence[str | Image.Image]) -> np.ndarray:
        """→ (B, H, W, 3) float32 NHWC; a batch of paths only through the
        native loader when it is built."""
        imgs = list(imgs)
        if imgs and all(isinstance(i, str) for i in imgs):
            from clip_lora_match_tpu_torch.data.native_loader import (
                native_available,
                preprocess_image_batch_native,
            )

            if native_available():
                return preprocess_image_batch_native(imgs, self.pre)
        return preprocess_image_batch(imgs, self.pre)

    def preprocess_text(self, text: str | Sequence[str]) -> dict[str, np.ndarray]:
        """→ {"input_ids": (B,77), "attention_mask": (B,77)}, padded at the end."""
        return self.tokenizer(
            text,
            max_length=self.pre.max_text_length,
            pad_to_max=True,
            truncate=self.pre.truncate,
        )

    def preprocess_pair(self, img: str | Image.Image, text: str) -> dict[str, np.ndarray]:
        """→ {"pixel_values": (1,H,W,3), "input_ids": (1,77), "attention_mask": (1,77)}."""
        out = self.preprocess_text(text)
        out["pixel_values"] = self.preprocess_image(img)
        return out
