"""High-level CLIP encoder (port of ``models/encoder.py::ClipEncoder``).

Encodes text and images to L2-normalized float32 embeddings on ``device``
(default ``"cuda"``). Kept from the JAX package: the batch buckets (padded
batches sliced on exit), the 77→64 text slice, the dropped text padding mask
in serving (causal masking makes it redundant for the EOT-pooled output),
and bf16 compute with fp32 accumulation on the accelerator (fp32 on the CPU).

``encode_image_files`` is the throughput entry point over JPEG paths: the
native loader decodes batch i+1 on a background thread while the device
encodes batch i, the pixels cross as uint8 (scaled, CLIP-normalized and cast
to the compute dtype on the device), and readback lags dispatch by up to 3
batches through pinned host buffers.

The master weights stay fp32. A serving copy (matmul kernels and LoRA
factors in the compute dtype, transformer layers unstacked into per-layer
views, each adapted attention layer's q/k/v operands grouped for one
``lora_matmul`` launch) is built at the first encode and rebuilt only when
the weights or the adapter change, so a request never re-reads the fp32 tree
to cast it. Under ``quantize="int8"`` (W8A8, ``quant/int8.py``) the serving
copy's transformer-block linears are int8, quantized from the fp32 master;
the other leaves take the float path's serving dtype, and the adapter stays
fp32, cast per call to the type of the input it meets, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from clip_lora_match_tpu_torch.core.config import ClipArchConfig, ClipConfig, load_clip_config
from clip_lora_match_tpu_torch.core.device import resolve_device
from clip_lora_match_tpu_torch.models import clip as clip_model
from clip_lora_match_tpu_torch.models.io import load_params, save_params, to_device
from clip_lora_match_tpu_torch.nn.layers import (
    QKV,
    group_int8_qkv,
    group_qkv,
    kernel_flags,
    unstack_blocks,
)
from clip_lora_match_tpu_torch.preprocess.pipeline import ClipPreprocessor

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 96, 128, 256, 512, 1024)

# Batches whose real tokens all fit in 64 columns run the text tower at S=64.
_TEXT_SEQ_SLICE = 64

_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# encode_image_files: batches decoded ahead, and batches whose readback may
# lag their dispatch
_PREFETCH_DEPTH = 2
_READBACK_LAG = 3
# how encode_image_files moves its batches on CUDA: "pinned" copies each
# decoded batch into a pinned buffer (an asynchronous upload) and reads back
# through pinned buffers; "pageable" copies synchronously both ways
HOST_STAGING = ("pinned", "pageable")


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // _BUCKETS[-1]) * _BUCKETS[-1]


def _serving_tree(tree, dtype: Optional[torch.dtype], key: str = ""):
    """Copy of a param/LoRA tree for the hot path: matmul operands
    (``kernel``, ``a``, ``b``) cast to ``dtype``, everything else as is,
    stacked ``blocks`` unstacked into per-layer lists. LoRA ``a`` (in, r) is
    held as the transposed view of a contiguous (r, in) tensor, the layout
    ``lora_matmul``'s kernel reads, and an int8 ``kernel_q`` (in, out) as the
    transposed view of a contiguous (out, in) one, the layout of the int8
    product's K-contiguous operands."""
    if isinstance(tree, dict):
        out = {k: _serving_tree(v, dtype, k) for k, v in tree.items()}
        if "blocks" in out:
            out["blocks"] = unstack_blocks(out["blocks"])
        return out
    if dtype is not None and key in ("kernel", "a", "b"):
        tree = tree.to(dtype)
    if key in ("a", "kernel_q"):
        tree = tree.transpose(-1, -2).contiguous().transpose(-1, -2)
    return tree


def _group_attention(params, lora, dtype: Optional[torch.dtype]) -> None:
    """In the serving copy: give every attention layer whose q, k and v carry
    adapters of one rank its grouped operands (``lora[...]["attn"]["qkv"]``,
    ``nn.layers.group_qkv``) and make its q/k/v kernels column views of the
    grouped W, so the grouped copy takes their place."""
    for tower, tree in lora.items():
        for p_layer, l_layer in zip(params[tower]["blocks"], tree.get("blocks", [])):
            group = group_qkv(p_layer["attn"], l_layer.get("attn"), dtype)
            if group is None:
                continue
            l_layer["attn"]["qkv"] = group
            D = group["kernel"].shape[1] // 3
            for i, n in enumerate(QKV):
                p_layer["attn"][n] = {**p_layer["attn"][n], "kernel": group["kernel"][:, i * D:(i + 1) * D]}


class ClipEncoder:
    """Stateful wrapper around the functional CLIP towers."""

    def __init__(
        self,
        params,
        arch: ClipArchConfig | None = None,
        config: ClipConfig | None = None,
        lora=None,
        lora_scaling: float = 1.0,
        compute_dtype: Optional[str] = None,
        quantize: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = config or ClipConfig()
        self.arch = arch or self.cfg.arch
        # int8 W8A8 serving: the argument, else the config's model.quantize
        self.quantize = quantize if quantize is not None else self.cfg.quantize
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize mode {self.quantize!r}")
        on_cuda = self.device.type == "cuda"
        # explicit compute dtype wins; else the config's compute dtype on
        # CUDA and its storage dtype on the CPU; "float32" means fp32 compute
        if compute_dtype is not None:
            dt = compute_dtype
        else:
            dt = self.cfg.compute_dtype if on_cuda else self.cfg.dtype
        self.compute_dtype = None if dt in (None, "float32") else _DTYPE_NAMES[dt]
        self.params = to_device(params, self.device, torch.float32)
        self.lora = None if lora is None else to_device(lora, self.device, torch.float32)
        self.lora_scaling = lora_scaling
        self.preprocessor = ClipPreprocessor(config=self.cfg)
        self.eot_id = self.preprocessor.tokenizer.eot_id
        pre = self.cfg.preprocess
        self._pix_mean = torch.tensor(pre.mean, dtype=torch.float32, device=self.device)
        self._pix_std = torch.tensor(pre.std, dtype=torch.float32, device=self.device)
        self.host_staging = "pinned"  # one of HOST_STAGING; phase 7 of chip_smoke.py times both
        self._serving = None
        self._serving_lock = threading.Lock()

    # -- construction -----------------------------------------------------------

    @classmethod
    def from_config(
        cls,
        config_path: Optional[str] = None,
        weights_path: Optional[str] = None,
        lora_path: Optional[str] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> "ClipEncoder":
        """Build from the YAML config (``model.name`` picks the preset, a
        ``model.arch:`` block overrides it). Loads the ``.npz`` weights when
        given and found, else initializes from ``seed`` with a warning; a
        missing LoRA directory warns and keeps the base weights. The LoRA
        directory is native or PEFT (``lora.adapter.load_lora``); a PEFT
        adapter is stacked to this config's arch."""
        cfg = load_clip_config(config_path)
        arch = cfg.arch
        dev = resolve_device(device)
        if weights_path and os.path.exists(weights_path):
            params = load_params(weights_path, device=dev)
        else:
            if weights_path:
                warnings.warn(f"weights not found at {weights_path}; random init")
            else:
                warnings.warn("no weights_path given; using random initialization")
            params = clip_model.init_params(seed, arch, device=dev)
        enc = cls(params, arch=arch, config=cfg, device=dev)
        if lora_path:
            from clip_lora_match_tpu_torch.lora.adapter import load_lora

            if os.path.exists(lora_path):
                enc.attach_lora(*load_lora(lora_path, device=dev, arch=arch))
            else:
                warnings.warn(f"LoRA weights not found at {lora_path}; using base model")
        return enc

    # -- LoRA -----------------------------------------------------------------

    def attach_lora(self, lora_params, scaling: float) -> None:
        """Serve ``lora_params`` at ``scaling``; None serves the base model."""
        self.lora = None if lora_params is None else to_device(lora_params, self.device, torch.float32)
        self.lora_scaling = scaling
        self._serving = None

    def merge_lora(self) -> None:
        """Fold the adapter into the base weights (W' = W + s·A@B) and drop it."""
        from clip_lora_match_tpu_torch.lora.adapter import merge_lora

        if self.lora is not None:
            self.params = merge_lora(self.params, self.lora, self.lora_scaling)
            self.lora = None
            self._serving = None

    def _dispatch(self):
        """The kernel switches are left as they are (by default kernels on
        CUDA tensors, the exact plain paths on the CPU); a config with
        ``use_pallas_kernels: false`` runs this encoder's calls plain, every
        kernel off (the switch is process-wide while such a call runs)."""
        if self.cfg.use_pallas_kernels:
            return contextlib.nullcontext()
        return kernel_flags(
            fused_lora=False, small_attention=False, flash_attention=False, fused_mlp=False
        )

    def _serving_state(self):
        # request threads (the device crop) and the batch queue's worker may
        # both reach the first encode: one of them builds the copy
        with self._serving_lock:
            if self._serving is None:
                if self.quantize == "int8":
                    from clip_lora_match_tpu_torch.quant.int8 import quantize_clip_params

                    params = _serving_tree(quantize_clip_params(self.params), self.compute_dtype)
                    for tower in ("visual", "text"):
                        for layer in params[tower]["blocks"]:
                            group_int8_qkv(layer["attn"])
                    lora = None if self.lora is None else _serving_tree(self.lora, None)
                else:
                    params = _serving_tree(self.params, self.compute_dtype)
                    lora = None if self.lora is None else _serving_tree(self.lora, self.compute_dtype)
                    if lora is not None:
                        _group_attention(params, lora, self.compute_dtype)
                self._serving = (params, lora)
            return self._serving

    # -- batched encode (bucketed shapes) ----------------------------------------

    @torch.inference_mode()
    def encode_image_batch(
        self, pixel_values: np.ndarray | torch.Tensor, normalize: bool = True
    ) -> np.ndarray:
        """(N, H, W, 3) float32 array, or a tensor (the device crop's, which
        stays on the device) → (N, projection_dim) float32 embeddings."""
        n = pixel_values.shape[0]
        if n == 0:
            return np.zeros((0, self.arch.projection_dim), np.float32)
        if isinstance(pixel_values, np.ndarray):
            pixel_values = torch.from_numpy(np.ascontiguousarray(pixel_values, np.float32))
        pix = pixel_values.to(self.device, torch.float32)
        b = _bucket(n)
        if b != n:  # padded on the device
            pix = torch.cat([pix, pix.new_zeros((b - n,) + tuple(pix.shape[1:]))])
        params, lora = self._serving_state()
        with self._dispatch():
            feats = clip_model.encode_image_features(
                params, pix, self.arch, lora=lora, lora_scaling=self.lora_scaling,
                compute_dtype=self.compute_dtype,
            )
        if normalize:
            feats = clip_model.l2_normalize(feats)
        return feats[:n].float().cpu().numpy()

    @torch.inference_mode()
    def encode_text_batch(
        self,
        input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray] = None,
        normalize: bool = True,
    ) -> np.ndarray:
        """(N, S) token ids → (N, projection_dim) float32 embeddings."""
        n = input_ids.shape[0]
        if n == 0:
            return np.zeros((0, self.arch.projection_dim), np.float32)
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        # trailing all-pad columns cannot reach the EOT-pooled output under
        # causal masking, so a batch whose real tokens fit in 64 columns (and
        # whose EOT survives the cut) runs at S=64
        if (
            input_ids.shape[1] > _TEXT_SEQ_SLICE
            and not attention_mask[:, _TEXT_SEQ_SLICE:].any()
            and (input_ids[:, :_TEXT_SEQ_SLICE] == self.eot_id).any(axis=1).all()
        ):
            input_ids = input_ids[:, :_TEXT_SEQ_SLICE]
        b = _bucket(n)
        if b != n:
            pad_ids = np.full((b - n, input_ids.shape[1]), self.eot_id, input_ids.dtype)
            input_ids = np.concatenate([input_ids, pad_ids])
        params, lora = self._serving_state()
        ids = torch.from_numpy(np.ascontiguousarray(input_ids, np.int64)).to(self.device)
        # serving drops the padding mask: pads sit after the EOT position and
        # the causal mask keeps them from influencing it
        with self._dispatch():
            feats = clip_model.encode_text_features(
                params, ids, self.arch, attention_mask=None, eot_id=self.eot_id,
                lora=lora, lora_scaling=self.lora_scaling, compute_dtype=self.compute_dtype,
            )
        if normalize:
            feats = clip_model.l2_normalize(feats)
        return feats[:n].float().cpu().numpy()

    def _encode_u8(self, u8: torch.Tensor, normalize: bool) -> torch.Tensor:
        """(B, S, S, 3) uint8 on the device → (bucket(B), D) float32 features:
        scaled and CLIP-normalized in fp32 on the device, cast to the compute
        dtype before the tower (so the residual stream is in that dtype), the
        bucket padded with zero pixels."""
        b = u8.shape[0]
        bb = _bucket(b)
        if bb != b:
            u8 = torch.cat([u8, u8.new_zeros((bb - b,) + tuple(u8.shape[1:]))])
        x = (u8.float() / 255.0 - self._pix_mean) / self._pix_std
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        params, lora = self._serving_state()
        with self._dispatch():
            feats = clip_model.encode_image_features(
                params, x, self.arch, lora=lora, lora_scaling=self.lora_scaling,
                compute_dtype=self.compute_dtype,
            )
        if normalize:
            feats = clip_model.l2_normalize(feats)
        return feats.float()

    @torch.inference_mode()
    def encode_image_files(
        self,
        paths: Sequence[str],
        batch_size: int = 96,
        normalize: bool = True,
        num_threads: Optional[int] = None,
        dct_scale: Optional[bool] = None,
    ) -> np.ndarray:
        """JPEG paths → (N, D) float32 embeddings, the host decode overlapped
        with the device's work: the native loader (``data/native_loader.py``,
        PIL rows for what it cannot decode) prepares batch i+1 on a
        background thread while the device encodes batch i, and batch i's
        embeddings are read back up to 3 batches later, one wait per batch.

        ``dct_scale`` (default on here): decode large JPEGs at libjpeg's
        smallest N/8 scale that covers the target's short side; pass False
        for the PIL pipeline's pixels."""
        from clip_lora_match_tpu_torch.data.dataset import prefetch
        from clip_lora_match_tpu_torch.data.native_loader import preprocess_image_batch_native_u8

        if self.host_staging not in HOST_STAGING:
            raise ValueError(f"host_staging must be one of {HOST_STAGING}, got {self.host_staging!r}")
        if dct_scale is None:
            dct_scale = True
        paths = list(paths)
        n, D, S = len(paths), self.arch.projection_dim, self.cfg.preprocess.image_size
        out = np.zeros((n, D), np.float32)
        if n == 0:
            return out
        staging = self.host_staging if self.device.type == "cuda" else "pageable"
        if staging == "pinned":
            # a slot comes round again _READBACK_LAG + 1 batches later, when
            # the drain has seen that batch's work (its upload included) end
            stage = _PinnedRing(_READBACK_LAG + 1, (batch_size, S, S, 3), torch.uint8)
            back = _PinnedRing(_READBACK_LAG + 1, (_bucket(batch_size), D), torch.float32)

        def batches():
            for i in range(0, n, batch_size):
                yield preprocess_image_batch_native_u8(
                    paths[i:i + batch_size], cfg=self.cfg.preprocess, num_threads=num_threads,
                    dct_scale=dct_scale,
                )

        pending: deque = deque()  # (event, pinned buffer, row, rows)
        row = 0
        for u8 in prefetch(batches(), depth=_PREFETCH_DEPTH):
            b = u8.shape[0]
            if staging == "pageable":
                feats = self._encode_u8(torch.from_numpy(u8).to(self.device), normalize)
                out[row:row + b] = feats[:b].cpu().numpy()
                row += b
                continue
            slot, buf = stage.take()
            buf[:b].copy_(torch.from_numpy(u8))
            x = buf[:b].to(self.device, non_blocking=True)
            stage.done(slot)
            feats = self._encode_u8(x, normalize)
            slot, host = back.take()
            host[:b].copy_(feats[:b], non_blocking=True)
            pending.append((back.done(slot), host, row, b))
            if len(pending) > _READBACK_LAG:
                _drain(pending, out)
            row += b
        while pending:
            _drain(pending, out)
        return out

    # -- convenience API ----------------------------------------------------------

    def encode_image(self, img: str | Image.Image | Sequence, normalize: bool = True) -> np.ndarray:
        """Single path/PIL image → (D,); a list → (N, D)."""
        single = isinstance(img, (str, Image.Image))
        items = [img] if single else list(img)
        out = self.encode_image_batch(self.preprocessor.preprocess_images(items), normalize)
        return out[0] if single else out

    def encode_text(self, text: str | Sequence[str], normalize: bool = True) -> np.ndarray:
        """Single str → (D,); a list → (N, D)."""
        single = isinstance(text, str)
        enc = self.preprocessor.preprocess_text(text)
        out = self.encode_text_batch(enc["input_ids"], enc["attention_mask"], normalize)
        return out[0] if single else out

    def save(self, path: str) -> None:
        """Write the fp32 master weights as a flat ``.npz`` (``models/io.py``)."""
        save_params(path, self.params)


class _PinnedRing:
    """Pinned host buffers of one shape, taken in turn; a buffer is handed out
    again only after the device's copy that last used it has finished (the
    event ``done`` recorded after that copy)."""

    def __init__(self, slots: int, shape: tuple, dtype: torch.dtype):
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(slots)]
        self.events: list = [None] * slots
        self.next = 0

    def take(self) -> tuple[int, torch.Tensor]:
        slot = self.next
        self.next = (slot + 1) % len(self.bufs)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        return slot, self.bufs[slot]

    def done(self, slot: int) -> torch.cuda.Event:
        """Mark the copy just enqueued on the current stream as the slot's last use."""
        ev = torch.cuda.Event()
        ev.record()
        self.events[slot] = ev
        return ev


def _drain(pending: deque, out: np.ndarray) -> None:
    """Wait for the oldest readback and copy its rows out of pinned memory."""
    ev, host, row, b = pending.popleft()
    ev.synchronize()
    out[row:row + b] = host[:b].numpy()


def load_clip_model(
    config_path: Optional[str] = None,
    lora_path: Optional[str] = None,
    weights_path: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> ClipEncoder:
    """The JAX package's ``load_clip_model``: ``ClipEncoder.from_config``."""
    return ClipEncoder.from_config(
        config_path=config_path, weights_path=weights_path, lora_path=lora_path, device=device
    )
