"""Data-parallel batch encoding, the index build's scale path (port of
``parallel/sharded_encode.py``).

A batch is padded to a multiple of the ranks; each rank encodes its
contiguous rows on its device through a ``ClipEncoder`` of its own (the
serving copy, bf16 compute on the card, the kernels under the default
``"auto"`` flags: ``attention_small`` and, with an adapter, the grouped
``lora_matmul``), and the ranks' rows are all-gathered and cut back to the
batch. Parameters are replicated (checked once, ``mesh.replicated``).
Every rank gets the whole result.

``sharded_text_encode_fn`` is ``index.build``'s ``encode_fn``: tokenize on
the host, encode over the ranks. Every rank must call it on the same texts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig
from clip_lora_match_tpu_torch.models.encoder import _DTYPE_NAMES, ClipEncoder
from clip_lora_match_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    make_mesh,
    pad_to_multiple,
    replicated,
)

_DTYPE_NAME = {dtype: name for name, dtype in _DTYPE_NAMES.items()}


class ShardedEncoder:
    """Data-parallel text and image encoder over the ranks of ``mesh``."""

    def __init__(
        self,
        params,
        arch: ClipArchConfig,
        eot_id: Optional[int] = None,
        lora=None,
        lora_scaling: float = 1.0,
        mesh: Optional[Mesh] = None,
        compute_dtype: Optional[str] = None,
        config: Optional[ClipConfig] = None,
    ):
        """``compute_dtype``: ``"float32"``, ``"bfloat16"`` or None (the
        config's, as ``ClipEncoder``). ``config``: the encoder's config (its
        kernel switch, preprocessing); ``quantize`` stays off, as in the JAX
        package's sharded encoder."""
        self.mesh = mesh or make_mesh()
        self.arch = arch
        self.n_devices = self.mesh.n_data
        self._local = ClipEncoder(
            replicated(self.mesh, params), arch=arch, config=config,
            lora=None if lora is None else replicated(self.mesh, lora), lora_scaling=lora_scaling,
            compute_dtype=compute_dtype, quantize="none", device=self.mesh.device,
        )
        self.eot_id = self._local.eot_id if eot_id is None else eot_id
        self._local.eot_id = self.eot_id

    def _gather(self, local: np.ndarray, n: int) -> np.ndarray:
        rows = torch.from_numpy(local).to(self.mesh.device)
        return all_gather(self.mesh, rows).cpu().numpy()[:n]

    def _mine(self, x: np.ndarray) -> np.ndarray:
        b = x.shape[0] // self.n_devices
        return x[self.mesh.rank * b:(self.mesh.rank + 1) * b]

    def encode_text_batch(
        self, input_ids: np.ndarray, attention_mask: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """(N, S) token ids, the same on every rank → (N, projection_dim)
        float32 unit rows."""
        n = input_ids.shape[0]
        if n == 0:
            return np.zeros((0, self.arch.projection_dim), np.float32)
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        ids_p, _ = pad_to_multiple(np.asarray(input_ids), self.n_devices)
        ids_p[n:] = self.eot_id  # pad rows as the encoder's own bucket pads them
        mask_p, _ = pad_to_multiple(np.asarray(attention_mask), self.n_devices)
        local = self._local.encode_text_batch(self._mine(ids_p), self._mine(mask_p))
        return self._gather(local, n)

    def encode_image_batch(self, pixel_values: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) float32 pixels, the same on every rank →
        (N, projection_dim) float32 unit rows."""
        n = pixel_values.shape[0]
        if n == 0:
            return np.zeros((0, self.arch.projection_dim), np.float32)
        pix_p, _ = pad_to_multiple(np.asarray(pixel_values, np.float32), self.n_devices)
        return self._gather(self._local.encode_image_batch(self._mine(pix_p)), n)


def sharded_text_encode_fn(encoder: ClipEncoder, mesh: Optional[Mesh] = None):
    """An ``encode_fn`` for ``index.build`` over a ``ClipEncoder``'s weights:
    tokenize on the host, encode over the ranks."""
    sh = ShardedEncoder(
        encoder.params, encoder.arch, eot_id=encoder.eot_id, lora=encoder.lora,
        lora_scaling=encoder.lora_scaling, mesh=mesh or make_mesh(device=encoder.device),
        compute_dtype=_DTYPE_NAME.get(encoder.compute_dtype, "float32"),
        config=encoder.cfg,
    )

    def encode(texts: Sequence[str]) -> np.ndarray:
        enc = encoder.preprocessor.preprocess_text(list(texts))
        return sh.encode_text_batch(enc["input_ids"], enc["attention_mask"])

    return encode
