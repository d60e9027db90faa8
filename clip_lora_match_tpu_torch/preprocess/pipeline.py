"""Unified image+text preprocessor (PIL images, pure-Python BPE).

Port of ``clip_lora_match_tpu/preprocess/pipeline.py`` without the native JPEG
loader: every image goes through the PIL pipeline in ``preprocess/image.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image

from clip_lora_match_tpu_torch.core.config import ClipConfig, load_clip_config
from clip_lora_match_tpu_torch.preprocess.image import preprocess_image_batch
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

    def preprocess_images(self, imgs: Sequence[str | Image.Image]) -> np.ndarray:
        """→ (B, H, W, 3) float32 NHWC."""
        return preprocess_image_batch(list(imgs), self.pre)

    def preprocess_text(self, text: str | Sequence[str]) -> dict[str, np.ndarray]:
        """→ {"input_ids": (B,77), "attention_mask": (B,77)}, padded at the end."""
        return self.tokenizer(
            text,
            max_length=self.pre.max_text_length,
            pad_to_max=True,
            truncate=self.pre.truncate,
        )
