"""Search front-end over an EmbeddingIndex (port of ``retrieval/search.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
from clip_lora_match_tpu_torch.retrieval.similarity import top_k_similar


@dataclass
class SearchResult:
    index: int
    score: float
    image_path: Optional[str]
    text: Optional[str]


class SearchIndex:
    """Top-k cosine search over an embedding index that stays on its device."""

    def __init__(self, index: EmbeddingIndex):
        self.index = index

    def search_with_embedding(self, query: np.ndarray, k: int = 5) -> list[SearchResult]:
        """(D,) or (1, D) query → top-k results."""
        q = np.asarray(query, np.float32)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]
        if q.ndim != 1:
            raise ValueError(f"query must be (D,) or (1,D), got {q.shape}")
        if q.shape[0] != self.index.dim:
            raise ValueError(f"query dim {q.shape[0]} != index dim {self.index.dim}")
        if len(self.index) == 0:
            return []
        # the lock keeps an append from swapping the arena mid-search
        with self.index.lock:
            scores, idx = top_k_similar(q, self.index.embeddings, k, assume_normalized=True)
        results = []
        for s, i in zip(scores, idx):
            path, text = self.index.metadata(int(i))
            results.append(SearchResult(int(i), float(s), path, text))
        return results
