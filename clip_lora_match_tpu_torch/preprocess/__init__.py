from clip_lora_match_tpu_torch.preprocess.augment import ImageAugmenter, default_augmenter
from clip_lora_match_tpu_torch.preprocess.image import (
    preprocess_image,
    preprocess_image_batch,
    preprocess_pil,
)
from clip_lora_match_tpu_torch.preprocess.pipeline import ClipPreprocessor

__all__ = [
    "ClipPreprocessor",
    "ImageAugmenter",
    "default_augmenter",
    "preprocess_image",
    "preprocess_image_batch",
    "preprocess_pil",
]
