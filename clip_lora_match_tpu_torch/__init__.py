"""PyTorch/CUDA port of clip_lora_match_tpu on an NVIDIA H100: the seeker, finder and
service graph, CLIP towers up to ViT-L/14-336, and hand-written kernels for every Pallas kernel."""

__version__ = "0.1.0"
