"""Search front-end over an EmbeddingIndex (port of ``retrieval/search.py``).

Shape-validated queries, top-k results with their metadata; the index stays
on its device between calls and the encoder is injected. ``quantize="int8"``
serves from a per-row int8 copy of the index (``topk_retrieve_q8``), cached
on the row count and extended by the appended rows only, and takes
precedence over ``approximate``; ``approximate=True`` selects through
``ops.approx_topk`` at ``recall_target``.

Concurrent ``search_with_embedding`` callers share passes: each queues its
query and waits for ``index.lock``; the thread that takes the lock serves
every query queued by then, one ``_topk`` pass per distinct ``k`` of at most
``PASS_QUERIES`` queries, and a caller whose query a pass has already served
takes the lock only to release it. A lone caller runs the one-query pass it
ran alone. Every caller records its wait for ``index.lock``
(``search.lock_wait``) in ``profiling.RECORDER``; the thread that runs a
pass records it (``search.locked``: the top-k and its readback, ``n`` its
queries). ``search_batch`` holds the lock for its own pass.
"""

from __future__ import annotations

import contextlib
import os
import threading
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

# the most queries one shared pass takes: pass 1's largest query block (the
# mma body's 64, ``retrieval_topk.tilemax_plan``), so a pass reads the index once
PASS_QUERIES = 64


@dataclass
class SearchResult:
    index: int
    score: float
    image_path: Optional[str]
    text: Optional[str]


@dataclass(eq=False)
class _Pending:
    """One ``search_with_embedding`` query waiting for a pass, and what the
    pass gave it: (k,) scores and ids, or the exception it raised."""

    query: np.ndarray
    k: int
    scores: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    done: bool = False


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
        self._pending: list[_Pending] = []
        self._pending_lock = threading.Lock()

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
        """``index.lock``, the wait for it recorded as a span."""
        with annotate("search.lock_wait"):
            self.index.lock.acquire()
        try:
            yield
        finally:
            self.index.lock.release()

    def _serve_pending(self) -> None:
        """Run every queued query: one pass per distinct ``k`` and per
        ``PASS_QUERIES`` queries, each recorded as one ``search.locked`` span
        carrying its query count. A pass's exception goes to each of its
        queries. The caller holds the index lock."""
        with self._pending_lock:
            batch, self._pending = self._pending, []
        by_k: dict[int, list[_Pending]] = {}
        for slot in batch:
            by_k.setdefault(slot.k, []).append(slot)
        for k, slots in by_k.items():
            for at in range(0, len(slots), PASS_QUERIES):
                group = slots[at:at + PASS_QUERIES]
                queries = np.stack([slot.query for slot in group])
                try:
                    with annotate("search.locked", n=len(group)):
                        scores, ids = self._topk(queries, k)
                except Exception as e:  # each caller of the pass raises it
                    for slot in group:
                        slot.error = e
                else:
                    for slot, s, i in zip(group, scores, ids):
                        slot.scores, slot.ids = s, i
                for slot in group:
                    slot.done = True

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
        """(D,) or (1, D) query → top-k results, from a pass shared with the
        callers queued beside it (the module's docstring)."""
        q = np.asarray(query, np.float32)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]
        if q.ndim != 1:
            raise ValueError(f"query must be (D,) or (1,D), got {q.shape}")
        if q.shape[0] != self.index.dim:
            raise ValueError(f"query dim {q.shape[0]} != index dim {self.index.dim}")
        if len(self.index) == 0:
            return []
        slot = _Pending(q, k)
        with self._pending_lock:
            self._pending.append(slot)
        # the lock keeps an append from swapping the arena mid-pass. A slot is
        # queued before its caller waits for the lock, and a lock holder serves
        # every slot it takes, so once its caller holds the lock a slot is
        # served or still queued
        with self._locked():
            if not slot.done:
                self._serve_pending()
        if slot.error is not None:
            raise slot.error
        if not slot.done:  # the pass that took it was interrupted
            raise RuntimeError("search_with_embedding: the pass that took this query did not finish")
        return self._results(slot.scores, slot.ids)

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
        with self._locked(), annotate("search.locked"):
            scores, idx = self._topk(queries, k)
        return [self._results(qs, qi) for qs, qi in zip(scores, idx)]


# the reference's class name
TextSearchIndex = SearchIndex
