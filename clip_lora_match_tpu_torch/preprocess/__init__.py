from clip_lora_match_tpu_torch.preprocess.image import (
    preprocess_image,
    preprocess_image_batch,
    preprocess_pil,
)
from clip_lora_match_tpu_torch.preprocess.pipeline import ClipPreprocessor

__all__ = ["preprocess_image", "preprocess_image_batch", "preprocess_pil", "ClipPreprocessor"]
