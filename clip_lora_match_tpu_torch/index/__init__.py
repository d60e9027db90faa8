from clip_lora_match_tpu_torch.index.build import (
    build_index_from_csv,
    build_text_index,
    read_custom_items_csv,
    read_pairs_csv,
    verify_index,
)
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex, load_index_q8, save_index_q8

__all__ = [
    "EmbeddingIndex",
    "build_index_from_csv",
    "build_text_index",
    "load_index_q8",
    "read_custom_items_csv",
    "read_pairs_csv",
    "save_index_q8",
    "verify_index",
]
