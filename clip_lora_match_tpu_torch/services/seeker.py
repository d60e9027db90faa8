"""SeekerService — the search (read) path (port of ``services/seeker.py``).

Text-only, image-only or both; fusion ``w_text·t + w_img·i`` renormalized
(0.5/0.5 by default); ``k=0`` returns nothing and ``k<0`` raises. The index
stays on its device between searches; an index the service loaded itself is
reloaded when its file's mtime moves (``watch_index_file``). The search
front-end lives as long as the index, so the int8 copy that
``index_quantize="int8"`` serves from is built once and follows appends.

With ``use_yolo_crop`` and a cropper, an image query is cropped first, as the
reference does: on disk (``cropper.crop_image`` → crop 0; a crop error gives
the original image), or with ``use_device_crop`` on the device
(``crop_embed_pipeline``: detect → crop → embed, no crop file). The device
path falls back to the disk path when the cropper has no live detector or the
device crop fails; ``device_crops`` counts the queries it served.
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
    # detector box → device crop → encoder, no crop file; the disk path stays
    # the behaviour-parity default and the fallback
    use_device_crop: bool = False
    watch_index_file: bool = True
    # "int8": serve from the quantized index (SearchIndex quantize="int8")
    index_quantize: str = "none"


class SeekerService:
    def __init__(
        self,
        encoder: ClipEncoder,
        config: Optional[SeekerConfig] = None,
        cropper=None,
        index: Optional[EmbeddingIndex] = None,
    ):
        self.cfg = config or SeekerConfig()
        self.encoder = encoder
        self.cropper = cropper if self.cfg.use_yolo_crop else None
        self.device_crops = 0  # image queries the device crop path served
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

    def _device_crop_embed(self, image: str | Image.Image) -> Optional[np.ndarray]:
        """Detect → device crop → embed. None sends the caller to the disk
        path: no live detector, or the device crop failed."""
        from clip_lora_match_tpu_torch.models.yolo.cropper import NullDetector
        from clip_lora_match_tpu_torch.models.yolo.device_crop import crop_embed_pipeline

        detector = getattr(self.cropper, "detector", None)
        if detector is None or isinstance(detector, NullDetector):
            return None
        try:
            img = (Image.open(image) if isinstance(image, str) else image).convert("RGB")
            emb, _ = crop_embed_pipeline(
                detector, self.encoder, img, k_best=1,
                conf=self.cropper.cfg.conf_threshold, iou=self.cropper.cfg.iou_threshold,
            )
        except Exception as e:  # the reference's fall-back-to-original semantics
            log.warning("device crop failed (%s); disk-path fallback", e)
            return None
        self.device_crops += 1
        return np.asarray(emb[0])

    def _image_embedding(self, image: str | Image.Image) -> np.ndarray:
        if self.cropper is not None and self.cfg.use_device_crop:
            emb = self._device_crop_embed(image)
            if emb is not None:
                return emb
        # the disk crop reads and writes files, so it takes a path
        if self.cropper is not None and isinstance(image, str):
            try:
                crops = self.cropper.crop_image(image)
                if crops:
                    image = crops[0]
            except Exception as e:
                log.warning("query crop failed (%s); using original", e)
        return self.encoder.encode_image(image)

    def _build_query_embedding(
        self, description: Optional[str], image: Optional[str | Image.Image]
    ) -> np.ndarray:
        if isinstance(image, str) and not image:
            image = None  # an empty path is no image, as in the JAX seeker
        if not description and image is None:
            raise ValueError("provide a description, an image, or both")
        text_emb = self.encoder.encode_text(description) if description else None
        image_emb = self._image_embedding(image) if image is not None else None
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
