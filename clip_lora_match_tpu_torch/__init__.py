"""PyTorch/CUDA port of clip_lora_match_tpu: the seeker read path on an NVIDIA H100."""

__version__ = "0.1.0"
