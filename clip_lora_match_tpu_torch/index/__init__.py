from clip_lora_match_tpu_torch.index.build import (
    build_index_from_csv,
    build_text_index,
    read_custom_items_csv,
    read_pairs_csv,
)
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex

__all__ = [
    "EmbeddingIndex",
    "build_index_from_csv",
    "build_text_index",
    "read_custom_items_csv",
    "read_pairs_csv",
]
