from clip_lora_match_tpu_torch.lora.adapter import (
    init_lora,
    load_lora,
    lora_param_count,
    merge_lora,
    save_lora,
)
from clip_lora_match_tpu_torch.lora.peft_io import load_peft_adapter, save_peft_adapter

__all__ = [
    "init_lora",
    "load_lora",
    "load_peft_adapter",
    "lora_param_count",
    "merge_lora",
    "save_lora",
    "save_peft_adapter",
]
