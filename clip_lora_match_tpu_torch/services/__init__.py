from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

__all__ = ["SeekerConfig", "SeekerService"]
