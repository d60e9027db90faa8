"""SeekerService — the search (read) path (port of ``services/seeker.py``).

Text-only, image-only or both; fusion ``w_text·t + w_img·i`` renormalized
(0.5/0.5 by default); ``k=0`` returns nothing and ``k<0`` raises. The index
stays on its device between searches; an index the service loaded itself is
reloaded when its file's mtime moves (``watch_index_file``). The search
front-end lives as long as the index, so the int8 copy that
``index_quantize="int8"`` serves from is built once and follows appends. The
YOLO crop stage is not ported yet: ``use_yolo_crop`` raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
from PIL import Image

from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder
from clip_lora_match_tpu_torch.retrieval.search import SearchIndex, SearchResult

log = get_logger("seeker")


@dataclass
class SeekerConfig:
    index_path: str = "data/index/custom_items_index.npz"
    top_k: int = 5
    text_weight: float = 0.5
    image_weight: float = 0.5
    use_yolo_crop: bool = False
    use_device_crop: bool = False
    watch_index_file: bool = True
    # "int8": serve from the quantized index (SearchIndex quantize="int8")
    index_quantize: str = "none"


class SeekerService:
    def __init__(
        self,
        encoder: ClipEncoder,
        config: Optional[SeekerConfig] = None,
        index: Optional[EmbeddingIndex] = None,
    ):
        self.cfg = config or SeekerConfig()
        if self.cfg.use_yolo_crop or self.cfg.use_device_crop:
            raise NotImplementedError("the YOLO crop stage is not ported to PyTorch yet")
        self.encoder = encoder
        self._shared_index = index is not None
        self.index = (
            index if index is not None
            else EmbeddingIndex.load(self.cfg.index_path, device=encoder.device)
        )
        self._mtime = self._index_mtime()
        self._search = SearchIndex(self.index, self.encoder, quantize=self.cfg.index_quantize)

    def _index_mtime(self) -> float:
        path = self.cfg.index_path
        npz = path if path.endswith((".npz", ".pt")) else path + ".npz"
        try:
            return os.path.getmtime(npz)
        except OSError:
            return 0.0

    def _maybe_reload(self) -> None:
        """Reload an index this service loaded itself when its file changed."""
        if self._shared_index or not self.cfg.watch_index_file:
            return
        m = self._index_mtime()
        if m > self._mtime:
            self.index = EmbeddingIndex.load(self.cfg.index_path, device=self.encoder.device)
            self._mtime = m
            self._search = SearchIndex(self.index, self.encoder, quantize=self.cfg.index_quantize)
            log.info("reloaded index (%d rows)", len(self.index))

    def _build_query_embedding(
        self, description: Optional[str], image: Optional[str | Image.Image]
    ) -> np.ndarray:
        if isinstance(image, str) and not image:
            image = None  # an empty path is no image, as in the JAX seeker
        if not description and image is None:
            raise ValueError("provide a description, an image, or both")
        text_emb = self.encoder.encode_text(description) if description else None
        image_emb = self.encoder.encode_image(image) if image is not None else None
        if text_emb is None:
            return image_emb
        if image_emb is None:
            return text_emb
        fused = self.cfg.text_weight * text_emb + self.cfg.image_weight * image_emb
        return fused / max(np.linalg.norm(fused), 1e-12)

    def search_items(
        self,
        description: Optional[str] = None,
        image_path: Optional[str | Image.Image] = None,
        k: Optional[int] = None,
    ) -> list[SearchResult]:
        """Top-k items for a description, an image (path or PIL image), or both;
        an empty path counts as no image."""
        self._maybe_reload()
        k = self.cfg.top_k if k is None else k
        if k < 0:
            raise ValueError(f"top_k must be >= 0, got {k}")
        if k == 0:
            return []
        query = self._build_query_embedding(description, image_path)
        return self._search.search_with_embedding(query, k)
