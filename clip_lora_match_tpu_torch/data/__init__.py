from clip_lora_match_tpu_torch.data.dataset import prefetch

__all__ = ["prefetch"]
