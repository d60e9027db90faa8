"""PEFT adapter checkpoints ↔ the port's LoRA tree (port of ``lora/peft_io.py``).

The reference trains with PEFT and saves an adapter directory of
``adapter_model.safetensors`` + ``adapter_config.json`` per epoch. This module
converts between that format and the stacked-block LoRA tree:

- PEFT key: ``base_model.model.{text|vision}_model.encoder.layers.{i}.
  self_attn.{q,k,v,out}_proj.lora_{A,B}.weight`` with A: (r, in), B: (out, r);
- ours: ``{tower}/blocks/attn/{proj}/{a,b}`` with a: (L, in, r), b: (L, r, out)
  (transposed, stacked on the layer axis).

The ``.safetensors`` file is read and written here with numpy alone (the
``safetensors`` package is not a dependency): an 8-byte little-endian header
length, a JSON header of ``{name: {dtype, shape, data_offsets}}`` (plus an
optional ``__metadata__``) padded with spaces to a multiple of 8 bytes, then
the tensors' raw little-endian bytes.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig

Params = dict[str, Any]

_KEY_RE = re.compile(
    r"(?:base_model\.model\.)?(text|vision)_model\.encoder\.layers\.(\d+)\."
    r"(self_attn|mlp)\.(q_proj|k_proj|v_proj|out_proj|fc1|fc2)\."
    r"lora_(A|B)\.weight"
)

_TOWER = {"vision": "visual", "text": "text"}
_TOWER_INV = {"visual": "vision_model", "text": "text_model"}

# safetensors dtype names ↔ numpy (little-endian); BF16 has no numpy type and
# is read as float32
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}
_NP_TO_ST = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file → ``{name: array}`` (``__metadata__`` skipped)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[base + begin:base + end]
        if info["dtype"] == "BF16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, _ST_DTYPES[info["dtype"]]).copy()
        out[name] = arr.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    """``{name: array}`` → a ``.safetensors`` file (tensors in name order)."""
    header: dict = {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        blob = arr.tobytes()  # C order
        header[name] = {"dtype": _NP_TO_ST[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def load_peft_adapter(
    path: str, arch: ClipArchConfig | None = None, device: str | torch.device = "cuda"
) -> tuple[Params, float]:
    """PEFT adapter dir → (LoRA tree of fp32 tensors on ``device``, scaling =
    alpha/r). Layers are stacked to ``arch``'s depth (ViT-B/32 by default);
    layers the file lacks stay zero."""
    from clip_lora_match_tpu_torch.core.device import resolve_device
    from clip_lora_match_tpu_torch.models.io import to_device

    dev = resolve_device(device)
    arch = arch or ClipArchConfig()
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    scaling = cfg["lora_alpha"] / cfg["r"]
    flat = read_safetensors(os.path.join(path, "adapter_model.safetensors"))

    # per (tower, group, proj, a|b): {layer: array}
    slots: dict[tuple[str, str, str, str], dict[int, np.ndarray]] = {}
    for key, arr in flat.items():
        m = _KEY_RE.match(key)
        if not m:
            continue
        tower_hf, layer, group_hf, proj, ab = m.groups()
        group = "attn" if group_hf == "self_attn" else "mlp"
        # PEFT A (r, in) → (in, r); B (out, r) → (r, out)
        slots.setdefault((_TOWER[tower_hf], group, proj, ab.lower()), {})[int(layer)] = arr.T

    tree: Params = {}
    for (tower, group, proj, ab), per_layer in slots.items():
        n_layers = arch.vision_layers if tower == "visual" else arch.text_layers
        sample = next(iter(per_layer.values()))
        stacked = np.zeros((n_layers,) + sample.shape, np.float32)
        for i, arr in per_layer.items():
            stacked[i] = arr
        tree.setdefault(tower, {"blocks": {}})["blocks"].setdefault(group, {}).setdefault(
            proj, {}
        )[ab] = stacked
    return to_device(tree, dev, torch.float32), scaling


def save_peft_adapter(path: str, lora: Params, cfg: LoraConfig) -> None:
    """LoRA tree (tensors on any device, or arrays) → a PEFT adapter dir
    (``adapter_model.safetensors`` + ``adapter_config.json``)."""
    from clip_lora_match_tpu_torch.models.io import flatten_params

    os.makedirs(path, exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    for tower, tree in lora.items():
        hf_tower = _TOWER_INV[tower]
        for group, projs in tree["blocks"].items():
            group_hf = "self_attn" if group == "attn" else "mlp"
            for proj, ab in projs.items():
                host = flatten_params(ab)
                a, b = host["a"], host["b"]
                for i in range(a.shape[0]):
                    base = f"base_model.model.{hf_tower}.encoder.layers.{i}.{group_hf}.{proj}"
                    flat[f"{base}.lora_A.weight"] = np.ascontiguousarray(a[i].T)
                    flat[f"{base}.lora_B.weight"] = np.ascontiguousarray(b[i].T)
    write_safetensors(os.path.join(path, "adapter_model.safetensors"), flat)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(
            {
                "peft_type": "LORA",
                "task_type": cfg.task_type,
                "base_model_name_or_path": cfg.base_model_name,
                "r": cfg.r,
                "lora_alpha": cfg.alpha,
                "lora_dropout": cfg.dropout,
                "bias": cfg.bias,
                "target_modules": list(cfg.target_modules),
                "fan_in_fan_out": False,
                "inference_mode": True,
            },
            f,
            indent=2,
        )
