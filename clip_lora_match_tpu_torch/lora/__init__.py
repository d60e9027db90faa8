from clip_lora_match_tpu_torch.lora.adapter import (
    init_lora,
    load_lora,
    lora_param_count,
    merge_lora,
)

__all__ = ["init_lora", "load_lora", "lora_param_count", "merge_lora"]
