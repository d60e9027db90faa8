"""FinderService — the report (write) path (port of ``services/finder.py``).

Copies the uploaded photo into ``reported_images_dir``; indexes the TEXT
embedding of ``"{description}, ditemukan di {location}"`` (not the image's:
the reference's behaviour, kept); inserts the DB row first, then appends the
row to the device index and persists it, all under one write lock, so a
failure between the two leaves a DB row that a rebuild from the DB repairs.
With ``use_yolo_crop`` and a cropper, the stored photo is cropped too
(``crop_used``; a crop error keeps the original), as the reference does; the
index row stays the text's embedding.
"""

from __future__ import annotations

import datetime as dt
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Optional

from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.db.store import BaseStore, FoundItem
from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

log = get_logger("finder")


@dataclass
class FinderConfig:
    index_path: str = "data/index/custom_items_index.npz"
    reported_images_dir: str = "data/reported/images"
    use_yolo_crop: bool = False
    location_template: str = "{description}, ditemukan di {location}"
    k_dim: int = 512
    persist_every_insert: bool = True


@dataclass
class ReportResult:
    item_id: Optional[int]
    index_row: int
    stored_image_path: str
    indexed_text: str
    crop_used: bool = False


class FinderService:
    def __init__(
        self,
        encoder: ClipEncoder,
        config: Optional[FinderConfig] = None,
        store: Optional[BaseStore] = None,
        cropper=None,
        index: Optional[EmbeddingIndex] = None,
    ):
        self.cfg = config or FinderConfig()
        self.encoder = encoder
        self.store = store
        self.cropper = cropper if self.cfg.use_yolo_crop else None
        self.index = (
            index if index is not None
            else EmbeddingIndex.load(self.cfg.index_path, dim=self.cfg.k_dim, device=encoder.device)
        )
        self._write_lock = threading.Lock()
        os.makedirs(self.cfg.reported_images_dir, exist_ok=True)

    def report_item(
        self,
        image_path: str,
        description: str,
        location: Optional[str] = None,
        found_at: Optional[dt.datetime] = None,
        reporter: Optional[str] = None,
    ) -> ReportResult:
        dest = os.path.join(self.cfg.reported_images_dir, os.path.basename(image_path))
        if os.path.abspath(image_path) != os.path.abspath(dest):
            shutil.copy2(image_path, dest)
        crop_used = False
        if self.cropper is not None:
            try:
                crop_used = bool(self.cropper.crop_image(dest))
            except Exception as e:
                log.warning("YOLO crop failed (%s); using original image", e)
        indexed_text = (
            self.cfg.location_template.format(description=description, location=location)
            if location
            else description
        )
        emb = self.encoder.encode_text(indexed_text)
        with self._write_lock:
            item_id = None
            if self.store is not None:
                # the DB row holds the location-joined text and defaults
                # found_at to now(), as the reference's row does
                item_id = self.store.insert(
                    FoundItem(
                        id=None,
                        image_path=dest,
                        description=indexed_text,
                        location=location,
                        found_at=found_at or dt.datetime.now(),
                        reporter=reporter,
                    )
                )
            row = self.index.append(emb, image_path=dest, text=indexed_text)
            if self.cfg.persist_every_insert:
                self.index.save(self.cfg.index_path)
        log.info("reported item row=%d id=%s text=%r", row, item_id, indexed_text)
        return ReportResult(
            item_id=item_id,
            index_row=row,
            stored_image_path=dest,
            indexed_text=indexed_text,
            crop_used=crop_used,
        )
