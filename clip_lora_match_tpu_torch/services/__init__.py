from clip_lora_match_tpu_torch.services.batch_queue import EncoderBatchQueue, QueuedEncoder
from clip_lora_match_tpu_torch.services.finder import FinderConfig, FinderService, ReportResult
from clip_lora_match_tpu_torch.services.seeker import SeekerConfig, SeekerService

__all__ = [
    "EncoderBatchQueue",
    "FinderConfig",
    "FinderService",
    "QueuedEncoder",
    "ReportResult",
    "SeekerConfig",
    "SeekerService",
]
