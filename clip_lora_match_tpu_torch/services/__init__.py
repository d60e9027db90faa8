from clip_lora_match_tpu_torch.services.finder import FinderConfig, FinderService, ReportResult
from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

__all__ = ["FinderConfig", "FinderService", "ReportResult", "SeekerConfig", "SeekerService"]
