from clip_lora_match_tpu_torch.core.config import (
    ClipArchConfig,
    ClipConfig,
    DBConfig,
    LoraConfig,
    PreprocessConfig,
    TrainingConfig,
    YoloConfig,
    load_clip_config,
    load_db_config,
    load_lora_config,
    load_yolo_config,
    to_dict,
)
from clip_lora_match_tpu_torch.core.device import resolve_device

__all__ = [
    "ClipArchConfig",
    "ClipConfig",
    "DBConfig",
    "LoraConfig",
    "PreprocessConfig",
    "TrainingConfig",
    "YoloConfig",
    "load_clip_config",
    "load_db_config",
    "load_lora_config",
    "load_yolo_config",
    "resolve_device",
    "to_dict",
]
