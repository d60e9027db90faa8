"""The port's training data pipeline and host utilities against the JAX
package's on the in-repo CSVs (``data/text/train_fashion.csv``, its images):
``ImageAugmenter(seed)`` images, ``ClipPairDataset`` items (float and uint8
feeds, with and without the augmenter) and ``batch_iterator`` batches
bit-equal; ``train_val_iterators``; ``MetricsWriter``'s JSONL; ``set_seed``,
``tree_size`` and ``tree_bytes``."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from clip_lora_match_tpu.core.config import PreprocessConfig as JPre
from clip_lora_match_tpu.core.logging import MetricsWriter as JMetrics
from clip_lora_match_tpu.data.dataset import ClipPairDataset as JDataset
from clip_lora_match_tpu.data.dataset import batch_iterator as j_batches
from clip_lora_match_tpu.preprocess.augment import ImageAugmenter as JAug
from clip_lora_match_tpu.tokenizer import ClipTokenizer as JTok
from clip_lora_match_tpu.utils import tree_bytes as j_tree_bytes
from clip_lora_match_tpu.utils import tree_size as j_tree_size
from clip_lora_match_tpu_torch.core.config import PreprocessConfig as TPre
from clip_lora_match_tpu_torch.core.logging import MetricsWriter as TMetrics
from clip_lora_match_tpu_torch.data import ClipPairDataset as TDataset
from clip_lora_match_tpu_torch.data import batch_iterator as t_batches
from clip_lora_match_tpu_torch.data import train_val_iterators
from clip_lora_match_tpu_torch.preprocess.augment import ImageAugmenter as TAug
from clip_lora_match_tpu_torch.preprocess.augment import default_augmenter
from clip_lora_match_tpu_torch.tokenizer import ClipTokenizer as TTok
from clip_lora_match_tpu_torch.utils import set_seed, tree_bytes, tree_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(REPO, "data/text/train_fashion.csv")
VAL = os.path.join(REPO, "data/text/val_fashion.csv")
ROWS = 12


def _images(n=6):
    import csv

    with open(CSV, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))[:n]
    return [Image.open(os.path.join(REPO, r["image_path"])).convert("RGB") for r in rows]


@pytest.mark.parametrize("seed", [0, 42])
def test_augmenter_gives_jax_images(seed):
    jaug, taug = JAug(seed=seed), TAug(seed=seed)
    for _ in range(3):  # enough rolls that every branch fires
        for img in _images():
            a, b = jaug(img), taug(img)
            assert a.size == b.size and np.array_equal(np.asarray(a), np.asarray(b))
    jaug.reseed(7)
    taug.reseed(7)
    img = _images(1)[0]
    assert np.array_equal(np.asarray(jaug(img)), np.asarray(taug(img)))
    assert default_augmenter(3).hflip_p == 0.5


def _datasets(u8, augment, size=64):
    jd = JDataset(CSV, JTok.from_dir(None, 77), JPre(image_size=size), image_root=REPO,
                  augmenter=JAug(seed=1) if augment else None, max_rows=ROWS, uint8_pixels=u8)
    td = TDataset(CSV, TTok.from_dir(None, 77), TPre(image_size=size), image_root=REPO,
                  augmenter=TAug(seed=1) if augment else None, max_rows=ROWS, uint8_pixels=u8)
    return jd, td


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("augment", [False, True])
def test_dataset_items_equal_jax(u8, augment):
    jd, td = _datasets(u8, augment)
    assert len(jd) == len(td) == ROWS and jd.texts == td.texts
    for i in range(ROWS):
        a, b = jd[i], td[i]
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
    assert td[0]["pixel_values"].dtype == (np.uint8 if u8 else np.float32)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (True, False)])
def test_batch_iterator_equals_jax(shuffle, drop_last):
    jd, td = _datasets(True, True)
    jb = list(j_batches(jd, 5, shuffle=shuffle, seed=42, epoch=3, drop_last=drop_last))
    tb = list(t_batches(td, 5, shuffle=shuffle, seed=42, epoch=3, drop_last=drop_last))
    assert len(jb) == len(tb) == (2 if drop_last else 3)
    for a, b in zip(jb, tb):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_train_val_iterators():
    _, td = _datasets(True, False)
    vd = TDataset(VAL, TTok.from_dir(None, 77), TPre(image_size=64), image_root=REPO, uint8_pixels=True)
    train_it, val_it = train_val_iterators(td, vd, 4, seed=42, epoch=0)
    assert [b["input_ids"].shape for b in train_it] == [(4, 77)] * 3
    assert [b["pixel_values"].shape for b in val_it] == [(4, 64, 64, 3)]
    _, none = train_val_iterators(td, vd, 8, seed=42, epoch=0)
    assert none is None  # 6 val rows hold no full batch of 8


def test_dataset_refuses_a_csv_without_its_columns(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("path,caption\na.jpg,x\n")
    with pytest.raises(ValueError, match="image_path"):
        TDataset(str(bad), TTok.from_dir(None, 77))


def test_metrics_writer_lines_match_jax(tmp_path):
    for cls, name in ((JMetrics, "jax.jsonl"), (TMetrics, "port.jsonl")):
        w = cls(str(tmp_path / "sub" / name))
        w.write("train_step", epoch=1, step=5, loss=1.25, grad_norm=0.5)
        w.write("val", epoch=1, loss=2.0)
        w.close()
        w.close()
    lines = {n: [json.loads(ln) for ln in (tmp_path / "sub" / n).read_text().splitlines()]
             for n in ("jax.jsonl", "port.jsonl")}
    for a, b in zip(lines["jax.jsonl"], lines["port.jsonl"]):
        assert {k: v for k, v in a.items() if k != "time"} == {k: v for k, v in b.items() if k != "time"}
        assert isinstance(b["time"], float)
    TMetrics(None).write("nothing")  # no path: writes nothing


def test_set_seed_and_tree_utils():
    import random

    g = set_seed(5)
    assert torch.equal(torch.rand(3, generator=g), torch.rand(3, generator=torch.Generator().manual_seed(5)))
    assert np.random.rand() == np.random.RandomState(5).rand()
    assert random.random() == random.Random(5).random()
    tree = {"a": {"w": np.zeros((3, 4), np.float32), "b": np.zeros((4,), np.int8)}, "c": np.zeros((2, 2))}
    ttree = {"a": {"w": torch.zeros(3, 4), "b": torch.zeros(4, dtype=torch.int8)},
             "c": torch.zeros(2, 2, dtype=torch.float64)}
    assert tree_size(tree) == tree_size(ttree) == int(j_tree_size(tree)) == 20
    assert tree_bytes(tree) == tree_bytes(ttree) == j_tree_bytes(tree) == 48 + 4 + 32
