from clip_lora_match_tpu_torch.models import clip
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder, load_clip_model
from clip_lora_match_tpu_torch.models.io import load_params, params_from_numpy, save_params

__all__ = ["clip", "ClipEncoder", "load_clip_model", "load_params", "params_from_numpy", "save_params"]
