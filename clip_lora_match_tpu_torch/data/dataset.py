"""CSV pair dataset and the host input pipeline (port of
``clip_lora_match_tpu/data/dataset.py``).

- ``ClipPairDataset``: the reference's CSV contract (``image_path,text``
  columns, ref:datasets/dataset.py:16-89); an item is the RGB image,
  augmented when the dataset has an augmenter, preprocessed to
  ``pixel_values`` (H, W, 3) float32 normalized, or uint8 resized and
  cropped for the feed normalized on the device, with the caption's
  ``input_ids`` and ``attention_mask`` (pre-tokenized, padded to the
  tokenizer's length);
- ``batch_iterator``: fixed-size batches (drop-last), shuffled per epoch by
  ``numpy.random.default_rng(seed + epoch).permutation``, as in the JAX
  package, so both give the same batches;
- ``prefetch``: a background thread that assembles the next batches while
  the device works on this one;
- ``train_val_iterators``: the two iterators of one epoch.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Iterator, Optional, Sequence, TypeVar

import numpy as np
from PIL import Image

from clip_lora_match_tpu_torch.core.config import PreprocessConfig
from clip_lora_match_tpu_torch.preprocess.augment import ImageAugmenter
from clip_lora_match_tpu_torch.preprocess.image import load_resized_cropped_u8, preprocess_pil

T = TypeVar("T")


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Run ``it`` in a background thread with a bounded queue of ``depth``
    items, so host work on item i+1 overlaps the consumer's work on item i.
    Items keep their order; an exception in ``it`` is raised in the consumer
    after the items before it.

    A consumer that stops early (``break``, an exception) closes the
    generator, whose ``finally`` sets the stop event: a worker blocked on a
    full queue sees it within 0.1 s and returns instead of holding ``depth``
    items for the life of the process."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # raised on the consumer's side
            err.append(e)
        finally:
            put(sentinel)  # unless the consumer has gone

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class ClipPairDataset:
    """Image-caption pairs from a CSV (ref:datasets/dataset.py:16-89)."""

    def __init__(
        self,
        csv_path: str,
        tokenizer,
        preprocess: Optional[PreprocessConfig] = None,
        image_root: str = ".",
        augment: bool = False,
        augmenter: Optional[ImageAugmenter] = None,
        max_rows: Optional[int] = None,
        uint8_pixels: bool = False,
    ):
        """``uint8_pixels``: items carry resized, cropped uint8
        ``pixel_values`` that the train and eval steps normalize on the
        device (the same numbers as the float feed at a quarter of the
        bytes)."""
        self.pre = preprocess or PreprocessConfig()
        self.uint8_pixels = uint8_pixels
        self.tokenizer = tokenizer
        self.image_root = image_root
        self.augmenter = augmenter or (ImageAugmenter() if augment else None)
        self.image_paths: list[str] = []
        self.texts: list[str] = []
        with open(csv_path, newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None or not {"image_path", "text"} <= set(reader.fieldnames):
                raise ValueError(
                    f"CSV must contain 'image_path' and 'text' columns, got {reader.fieldnames}"
                )
            for row in reader:
                self.image_paths.append(row["image_path"])
                self.texts.append(row["text"])
                if max_rows and len(self.texts) >= max_rows:
                    break
        enc = tokenizer(self.texts, pad_to_max=True)
        self._input_ids = enc["input_ids"]
        self._attention_mask = enc["attention_mask"]

    def __len__(self) -> int:
        return len(self.texts)

    def _resolve(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.image_root, path)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        img = Image.open(self._resolve(self.image_paths[i])).convert("RGB")
        if self.augmenter is not None:
            img = self.augmenter(img)
        if self.uint8_pixels:
            pix = load_resized_cropped_u8(img, self.pre)
        else:
            pix = preprocess_pil(
                img, image_size=self.pre.image_size, mean=self.pre.mean, std=self.pre.std,
                center_crop=self.pre.center_crop,
            )
        return {
            "pixel_values": pix,
            "input_ids": self._input_ids[i],
            "attention_mask": self._attention_mask[i],
        }


def batch_iterator(
    dataset: ClipPairDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 42,
    epoch: int = 0,
    drop_last: bool = True,
    indices: Optional[Sequence[int]] = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Fixed-shape numpy batches; the shuffle is deterministic per epoch."""
    idx = np.asarray(indices if indices is not None else np.arange(len(dataset)))
    if shuffle:
        idx = np.random.default_rng(seed + epoch).permutation(idx)
    end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    for start in range(0, end, batch_size):
        items = [dataset[int(i)] for i in idx[start:start + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def train_val_iterators(
    train_ds: ClipPairDataset,
    val_ds: Optional[ClipPairDataset],
    batch_size: int,
    seed: int,
    epoch: int,
) -> tuple[Iterator, Optional[Iterator]]:
    """One epoch's prefetched train batches and, when the val set holds a
    full batch, its prefetched val batches (unshuffled)."""
    train_it = prefetch(batch_iterator(train_ds, batch_size, shuffle=True, seed=seed, epoch=epoch))
    val_it = (
        prefetch(batch_iterator(val_ds, batch_size, shuffle=False, drop_last=True))
        if val_ds is not None and len(val_ds) >= batch_size
        else None
    )
    return train_it, val_it
