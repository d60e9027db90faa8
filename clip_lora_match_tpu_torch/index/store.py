"""Embedding index store: device-resident matrix + metadata (port of
``index/store.py``).

Rows live in a device arena (fp32, or bf16 to halve its bytes) that grows
geometrically, so an append is an O(1) row write. Rows are L2-normalized on
the way in. Disk format: ``.npz`` (``embeddings``) + ``.json`` sidecar
(``image_paths``, ``texts``), the JAX package's native format, or the
reference's legacy ``.pt`` torch dict (chosen by the suffix); the int8
index's artifact (``save_index_q8`` / ``load_index_q8``) is the JAX package's
too.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import threading
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.device import resolve_device

log = logging.getLogger("clip_lora_match_tpu_torch.index")

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _l2norm_rows(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


class EmbeddingIndex:
    """In-memory, device-backed embedding index with metadata."""

    def __init__(
        self,
        embeddings: Optional[np.ndarray] = None,
        image_paths: Optional[Sequence[str]] = None,
        texts: Optional[Sequence[str]] = None,
        dim: int = 512,
        normalize: bool = True,
        capacity: int = 0,
        storage_dtype: str = "float32",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if embeddings is None:
            embeddings = np.zeros((0, dim), np.float32)
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim != 2:
            raise ValueError(f"embeddings must be (N, D), got {embeddings.shape}")
        if normalize and embeddings.shape[0]:
            embeddings = _l2norm_rows(embeddings)
        self.dim = embeddings.shape[1]
        self.size = embeddings.shape[0]
        self.image_paths = list(image_paths or [])
        self.texts = list(texts or [])
        for name, meta in (("image_paths", self.image_paths), ("texts", self.texts)):
            if meta and len(meta) != self.size:
                warnings.warn(
                    f"index metadata '{name}' has {len(meta)} entries for "
                    f"{self.size} embedding rows"
                )
        self._storage_dtype = _STORAGE[storage_dtype]
        cap = max(capacity, self.size, 1)
        # ``lock`` is held by readers from taking ``embeddings`` through the
        # end of their search, and by ``append`` while it swaps the arena
        self.lock = threading.RLock()
        self._arena = torch.zeros((cap, self.dim), dtype=self._storage_dtype, device=self.device)
        if self.size:
            self._arena[: self.size] = torch.from_numpy(embeddings).to(self.device)

    # -- access ----------------------------------------------------------------

    @property
    def embeddings(self) -> torch.Tensor:
        """(N, D) device view of the live rows."""
        return self._arena[: self.size]

    def embeddings_np(self) -> np.ndarray:
        with self.lock:
            return self.embeddings.float().cpu().numpy()

    def metadata(self, i: int) -> tuple[Optional[str], Optional[str]]:
        path = self.image_paths[i] if i < len(self.image_paths) else None
        text = self.texts[i] if i < len(self.texts) else None
        return path, text

    def __len__(self) -> int:
        return self.size

    # -- mutation ---------------------------------------------------------------

    def append(
        self,
        embedding: np.ndarray,
        image_path: Optional[str] = None,
        text: Optional[str] = None,
        normalize: bool = True,
    ) -> int:
        """Append one row (the arena doubles when full). Returns its row id."""
        vec = np.asarray(embedding, np.float32).reshape(-1)
        if vec.shape[0] != self.dim:
            raise ValueError(f"embedding dim {vec.shape[0]} != index dim {self.dim}")
        if normalize:
            vec = _l2norm_rows(vec[None])[0]
        row = torch.from_numpy(vec).to(self.device)
        with self.lock:
            cap = self._arena.shape[0]
            if self.size >= cap:
                arena = torch.zeros(
                    (max(2 * cap, 8), self.dim), dtype=self._storage_dtype, device=self.device
                )
                arena[: self.size] = self._arena[: self.size]
                self._arena = arena
            self._arena[self.size] = row
            self.image_paths.append(image_path or "")
            self.texts.append(text or "")
            self.size += 1
            return self.size - 1

    # -- persistence -------------------------------------------------------------

    def _snapshot(self) -> tuple[np.ndarray, list, list]:
        """(embeddings fp32, image_paths, texts) read under one lock, so a
        concurrent append cannot skew the metadata against the rows."""
        with self.lock:
            return (self.embeddings.float().cpu().numpy(), list(self.image_paths),
                    list(self.texts))

    def save(self, path: str) -> None:
        """Write ``.npz`` (embeddings, fp32) + ``.json`` sidecar, or, for a
        ``.pt`` path, the reference's legacy torch dict."""
        if path.endswith(".pt"):
            self._save_pt(path)
            return
        emb, image_paths, texts = self._snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, embeddings=emb)
        side = path[:-4] if path.endswith(".npz") else path
        with open(side + ".json", "w") as f:
            json.dump({"image_paths": image_paths, "texts": texts}, f, ensure_ascii=False)

    def _save_pt(self, path: str) -> None:
        """The legacy dict with plural keys: ``embeddings`` a CPU fp32 tensor,
        ``image_paths`` and ``texts`` lists (the JAX package's layout)."""
        emb, image_paths, texts = self._snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(
            # a copy: a CPU index's rows are a view of its arena, and torch.save
            # writes a view's whole storage
            {"embeddings": torch.from_numpy(emb.copy()), "image_paths": image_paths,
             "texts": texts},
            path,
        )

    @classmethod
    def load(
        cls, path: str, dim: int = 512, device: str | torch.device = "cuda",
        storage_dtype: str = "float32",
    ) -> "EmbeddingIndex":
        """Load ``.npz`` (+ ``.json``) or a legacy ``.pt`` dict; a missing
        file gives an empty index."""
        if path.endswith(".pt"):
            if not os.path.exists(path):
                log.info("index %s not found; starting empty", path)
                return cls(dim=dim, device=device, storage_dtype=storage_dtype)
            emb, image_paths, texts = _load_pt(path)
            return cls(emb, image_paths, texts, device=device, storage_dtype=storage_dtype)
        npz = path if path.endswith(".npz") else path + ".npz"
        if not os.path.exists(npz):
            log.info("index %s not found; starting empty", npz)
            return cls(dim=dim, device=device, storage_dtype=storage_dtype)
        with np.load(npz) as data:
            emb = data["embeddings"]
        side = npz[:-4] + ".json"
        image_paths, texts = [], []
        if os.path.exists(side):
            with open(side) as f:
                meta = json.load(f)
            image_paths = meta.get("image_paths", meta.get("image_path", []))
            texts = meta.get("texts", meta.get("text", []))
        return cls(emb, image_paths, texts, device=device, storage_dtype=storage_dtype)


def _load_pt(path: str) -> tuple[np.ndarray, list, list]:
    """(embeddings, image_paths, texts) of a legacy torch dict, key-tolerant
    (``image_paths``/``image_path``, ``texts``/``text``). Loaded with
    ``weights_only=True``: a dict of a tensor and string lists needs no
    arbitrary pickle."""
    try:
        data = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError, EOFError) as e:
        raise ValueError(f"unrecognized index file {path}: {e}") from e
    if not isinstance(data, dict) or "embeddings" not in data:
        raise ValueError(f"unrecognized index file {path}")
    emb = data["embeddings"]
    emb = emb.float().numpy() if isinstance(emb, torch.Tensor) else np.asarray(emb, np.float32)
    image_paths = data.get("image_paths", data.get("image_path", []))
    texts = data.get("texts", data.get("text", []))
    return emb, list(image_paths), list(texts)


# -- quantized-index persistence -------------------------------------------------


def save_index_q8(
    path: str,
    values,
    scales,
    image_paths: Optional[Sequence[str]] = None,
    texts: Optional[Sequence[str]] = None,
) -> None:
    """Persist an int8 index (``ops.retrieval_topk.quantize_index_int8``'s
    output) as ``.npz`` (``values``, ``scales``) + ``.json`` sidecar, the JAX
    package's artifact format."""
    v = values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
    s = scales.cpu().numpy() if isinstance(scales, torch.Tensor) else np.asarray(scales)
    s = s.astype(np.float32, copy=False)
    if v.dtype != np.int8 or v.ndim != 2 or s.shape != (v.shape[0], 1):
        raise ValueError(
            f"expected (N, D) int8 values + (N, 1) scales, got "
            f"{v.dtype}{v.shape} / {s.shape}"
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, values=v, scales=s)
    side = path[:-4] if path.endswith(".npz") else path
    with open(side + ".json", "w") as f:
        json.dump(
            {"image_paths": list(image_paths or []), "texts": list(texts or [])},
            f, ensure_ascii=False,
        )


def load_index_q8(path: str, device: str | torch.device = "cuda"):
    """Load a ``save_index_q8`` artifact → (values (N, D) int8, scales (N, 1)
    fp32, both on ``device``, image_paths, texts)."""
    dev = resolve_device(device)
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as data:
        values = torch.from_numpy(data["values"]).to(dev)
        scales = torch.from_numpy(data["scales"]).to(dev)
    side = npz[:-4] + ".json"
    image_paths: list = []
    texts: list = []
    if os.path.exists(side):
        with open(side) as f:
            meta = json.load(f)
        image_paths = meta.get("image_paths", [])
        texts = meta.get("texts", [])
    return values, scales, image_paths, texts
