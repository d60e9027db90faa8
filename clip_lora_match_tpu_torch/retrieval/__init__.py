from clip_lora_match_tpu_torch.retrieval.search import SearchIndex, SearchResult
from clip_lora_match_tpu_torch.retrieval.similarity import l2_normalize, top_k_similar

__all__ = ["SearchIndex", "SearchResult", "l2_normalize", "top_k_similar"]
