from clip_lora_match_tpu_torch.core.config import (
    ClipArchConfig,
    ClipConfig,
    DBConfig,
    LoraConfig,
    PreprocessConfig,
    load_clip_config,
    load_db_config,
)
from clip_lora_match_tpu_torch.core.device import resolve_device

__all__ = [
    "ClipArchConfig",
    "ClipConfig",
    "DBConfig",
    "LoraConfig",
    "PreprocessConfig",
    "load_clip_config",
    "load_db_config",
    "resolve_device",
]
