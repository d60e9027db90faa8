"""Search front-end over an EmbeddingIndex (port of ``retrieval/search.py``).

Shape-validated queries, top-k results with their metadata; the index stays
on its device between calls and the encoder is injected. ``quantize="int8"``
serves from a per-row int8 copy of the index (``topk_retrieve_q8``), cached
on the row count and extended by the appended rows only, and takes
precedence over ``approximate``; ``approximate=True`` selects through
``ops.approx_topk`` at ``recall_target``. A search records its wait for
``index.lock`` (``search.lock_wait``) and its hold (``search.locked``: the
top-k and its readback) in ``profiling.RECORDER``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from PIL import Image

from clip_lora_match_tpu_torch.core.profiling import annotate
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
from clip_lora_match_tpu_torch.ops.retrieval_topk import quantize_index_int8, topk_retrieve_q8
from clip_lora_match_tpu_torch.retrieval.similarity import top_k_similar


@dataclass
class SearchResult:
    index: int
    score: float
    image_path: Optional[str]
    text: Optional[str]


class SearchIndex:
    """Top-k cosine search over an embedding index that stays on its device."""

    def __init__(
        self,
        index: EmbeddingIndex | str,
        encoder: Optional[ClipEncoder] = None,
        dim: int = 512,
        approximate: bool = False,
        recall_target: float = 0.95,
        quantize: str = "none",
        device: str | torch.device = "cuda",
    ):
        if isinstance(index, (str, os.PathLike)):
            index = EmbeddingIndex.load(str(index), dim=dim, device=device)
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
        self.index = index
        self.encoder = encoder
        self.approximate = approximate
        self.recall_target = recall_target
        self.quantize = quantize
        self._q8: Optional[tuple] = None  # (rows, values, scales)

    def _q8_state(self):
        """(values, scales) for the current rows; the caller holds the lock."""
        n = len(self.index)
        if self._q8 is not None and self._q8[0] == n:
            return self._q8[1], self._q8[2]
        if self._q8 is not None and 0 < self._q8[0] < n:
            # the index is append-only and the scales are per row: quantize
            # only the new rows and concatenate the int8 bytes
            n0, vq0, sc0 = self._q8
            vq1, sc1 = quantize_index_int8(self.index.embeddings[n0:])
            vq, sc = torch.cat([vq0, vq1]), torch.cat([sc0, sc1])
        else:
            vq, sc = quantize_index_int8(self.index.embeddings)
        self._q8 = (n, vq, sc)
        return vq, sc

    @contextlib.contextmanager
    def _locked(self):
        """``index.lock``, its wait and its hold recorded as spans."""
        with annotate("search.lock_wait"):
            self.index.lock.acquire()
        try:
            with annotate("search.locked"):
                yield
        finally:
            self.index.lock.release()

    def _topk(self, queries: np.ndarray, k: int):
        """One (Q, D) or (D,) batch → (Q, k) scores and ids, a (D,) query as
        one row (the JAX package's ``np.atleast_2d``); the caller holds the
        index lock."""
        if self.quantize == "int8":
            vq, sc = self._q8_state()
            q = torch.as_tensor(np.atleast_2d(queries), dtype=torch.float32, device=vq.device)
            s, i = topk_retrieve_q8(q, vq, sc, k)
            return s.cpu().numpy(), i.cpu().numpy()
        s, i = top_k_similar(queries, self.index.embeddings, k, assume_normalized=True,
                             approximate=self.approximate, recall_target=self.recall_target)
        return np.atleast_2d(s), np.atleast_2d(i)

    @classmethod
    def from_file(
        cls,
        path: str,
        encoder: Optional[ClipEncoder] = None,
        dim: int = 512,
        approximate: bool = False,
        recall_target: float = 0.95,
        device: str | torch.device = "cuda",
    ) -> "SearchIndex":
        return cls(EmbeddingIndex.load(path, dim=dim, device=device), encoder,
                   approximate=approximate, recall_target=recall_target)

    def _results(self, scores, idx) -> list[SearchResult]:
        out = []
        for s, i in zip(scores, idx):
            path, text = self.index.metadata(int(i))
            out.append(SearchResult(int(i), float(s), path, text))
        return out

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
        with self._locked():
            scores, idx = self._topk(q[None], k)
        return self._results(scores[0], idx[0])

    def _require_encoder(self) -> ClipEncoder:
        if self.encoder is None:
            raise RuntimeError("SearchIndex has no encoder attached")
        return self.encoder

    def search_by_text(self, text: str, k: int = 5) -> list[SearchResult]:
        return self.search_with_embedding(self._require_encoder().encode_text(text), k)

    def search_by_image(self, image: str | Image.Image, k: int = 5) -> list[SearchResult]:
        return self.search_with_embedding(self._require_encoder().encode_image(image), k)

    def search_batch(self, queries: np.ndarray, k: int = 5) -> list[list[SearchResult]]:
        """Query matrix (Q, D) → one result list per query; a (D,) query is
        one query."""
        queries = np.asarray(queries, np.float32)
        if len(self.index) == 0:
            return [[] for _ in range(queries.shape[0])]
        with self._locked():
            scores, idx = self._topk(queries, k)
        return [self._results(qs, qi) for qs, qi in zip(scores, idx)]


# the reference's class name
TextSearchIndex = SearchIndex
