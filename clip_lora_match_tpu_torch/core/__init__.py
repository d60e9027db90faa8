from clip_lora_match_tpu_torch.core.config import (
    ClipArchConfig,
    ClipConfig,
    LoraConfig,
    PreprocessConfig,
    load_clip_config,
)
from clip_lora_match_tpu_torch.core.device import resolve_device

__all__ = [
    "ClipArchConfig",
    "ClipConfig",
    "LoraConfig",
    "PreprocessConfig",
    "load_clip_config",
    "resolve_device",
]
