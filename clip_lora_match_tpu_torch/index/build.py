"""Index builders (port of ``index/build.py``): batched encodes into an
``EmbeddingIndex`` on the encoder's device. ``encode_fn`` replaces the
encoder's ``encode_text`` for a chunk of texts (another encoder, a sharded
one); ``verify_index`` checks counts and unit norms."""

from __future__ import annotations

import csv
import logging
from typing import Callable, Optional, Sequence

import numpy as np

from clip_lora_match_tpu_torch.index.store import EmbeddingIndex
from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

log = logging.getLogger("clip_lora_match_tpu_torch.index.build")


def build_text_index(
    texts: Sequence[str],
    image_paths: Sequence[str],
    encoder: ClipEncoder,
    batch_size: int = 256,
    encode_fn: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
) -> EmbeddingIndex:
    """Encode ``texts`` in batches (``encode_fn`` per chunk when given) →
    normalized index on the encoder's device."""
    encode = encode_fn or (lambda chunk: encoder.encode_text(list(chunk)))
    chunks = []
    for start in range(0, len(texts), batch_size):
        chunks.append(encode(texts[start : start + batch_size]))
        log.info("encoded %d/%d texts", min(start + batch_size, len(texts)), len(texts))
    emb = (
        np.concatenate(chunks)
        if chunks
        else np.zeros((0, encoder.arch.projection_dim), np.float32)
    )
    return EmbeddingIndex(
        emb, image_paths=list(image_paths), texts=list(texts), device=encoder.device
    )


def read_pairs_csv(csv_path: str) -> tuple[list[str], list[str]]:
    """Read an ``image_path,text`` CSV. Returns (image_paths, texts)."""
    image_paths, texts = [], []
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or not {"image_path", "text"} <= set(reader.fieldnames):
            raise ValueError(
                f"{csv_path} must have 'image_path' and 'text' columns, "
                f"got {reader.fieldnames}"
            )
        for row in reader:
            image_paths.append(row["image_path"])
            texts.append(row["text"])
    return image_paths, texts


def read_custom_items_csv(csv_path: str) -> tuple[list[str], list[str]]:
    """Parse the custom-items CSV whose text column holds unquoted commas:
    the first field is the image path, the remaining fields rejoined are the
    text."""
    image_paths, texts = [], []
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        next(reader, None)  # header
        for row in reader:
            if not row:
                continue
            image_paths.append(row[0])
            texts.append(",".join(row[1:]).strip())
    return image_paths, texts


def build_index_from_csv(
    csv_path: str,
    encoder: ClipEncoder,
    custom_format: bool = False,
    batch_size: int = 256,
    encode_fn: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
) -> EmbeddingIndex:
    reader = read_custom_items_csv if custom_format else read_pairs_csv
    image_paths, texts = reader(csv_path)
    return build_text_index(texts, image_paths, encoder, batch_size, encode_fn)


def verify_index(index: EmbeddingIndex) -> bool:
    """True when every row has an image path and a text and unit norm
    (within 1e-3); logs the counts otherwise."""
    n = len(index)
    norms = np.linalg.norm(index.embeddings_np(), axis=-1) if n else np.ones(0)
    norm_ok = bool(np.allclose(norms, 1.0, atol=1e-3))
    ok = len(index.image_paths) == n and len(index.texts) == n and norm_ok
    if not ok:
        log.warning(
            "index verify failed: rows=%d paths=%d texts=%d norm_ok=%s",
            n, len(index.image_paths), len(index.texts), norm_ok,
        )
    return ok
