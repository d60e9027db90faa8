from clip_lora_match_tpu_torch.retrieval.search import SearchIndex, SearchResult, TextSearchIndex
from clip_lora_match_tpu_torch.retrieval.similarity import (
    cosine_similarity,
    l2_normalize,
    top_k_similar,
)

__all__ = [
    "SearchIndex",
    "SearchResult",
    "TextSearchIndex",
    "cosine_similarity",
    "l2_normalize",
    "top_k_similar",
]
