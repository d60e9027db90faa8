"""LoRA adapters for the CLIP towers (port of ``lora/adapter.py``).

The adapter tree mirrors the base tree's stacked-block layout:
``{tower: {"blocks": {"attn": {proj: {"a": (L, in, r), "b": (L, r, out)}}}}}``.
Math: ``y = x@W + (α/r)·(x@A)@B``; B starts at zero, so a fresh adapter is a
no-op. ``merge_lora`` folds it: ``W' = W + (α/r)·A@B``. ``save_lora`` writes
the native directory (``lora_weights.npz`` + ``lora_config.json``), and
``load_lora`` reads it or a PEFT directory (``lora/peft_io.py``).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Sequence

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.config import ClipArchConfig, LoraConfig
from clip_lora_match_tpu_torch.models.io import load_params, save_params, tree_map

Params = dict[str, Any]
log = logging.getLogger("clip_lora_match_tpu_torch.lora")

_ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "out_proj")


def _proj_dims(arch: ClipArchConfig, tower: str, name: str) -> tuple[int, int]:
    width = arch.vision_width if tower == "visual" else arch.text_width
    mlp = arch.vision_mlp_dim if tower == "visual" else arch.text_mlp_dim
    if name in _ATTN_PROJS:
        return width, width
    if name == "fc1":
        return width, mlp
    if name == "fc2":
        return mlp, width
    raise ValueError(f"unknown target module {name}")


def init_lora(
    seed: int = 0,
    arch: ClipArchConfig | None = None,
    cfg: LoraConfig | None = None,
    towers: Sequence[str] = ("visual", "text"),
    device: str | torch.device = "cuda",
) -> Params:
    """Zero-effect adapter tree: A kaiming-uniform (bound 1/sqrt(in)), B zeros."""
    from clip_lora_match_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    arch = arch or ClipArchConfig()
    cfg = cfg or LoraConfig()
    rng = np.random.default_rng(seed)
    tree: Params = {}
    for tower in towers:
        layers = arch.vision_layers if tower == "visual" else arch.text_layers
        attn: Params = {}
        mlp: Params = {}
        for name in cfg.target_modules:
            d_in, d_out = _proj_dims(arch, tower, name)
            bound = 1.0 / np.sqrt(d_in)
            a = rng.uniform(-bound, bound, (layers, d_in, cfg.r)).astype(np.float32)
            entry = {
                "a": torch.from_numpy(a).to(dev),
                "b": torch.zeros((layers, cfg.r, d_out), device=dev),
            }
            (attn if name in _ATTN_PROJS else mlp)[name] = entry
        blocks: Params = {}
        if attn:
            blocks["attn"] = attn
        if mlp:
            blocks["mlp"] = mlp
        tree[tower] = {"blocks": blocks}
    log.info(
        "LoRA adapter: r=%d alpha=%d targets=%s trainable params=%s",
        cfg.r, cfg.alpha, list(cfg.target_modules), f"{lora_param_count(tree):,}",
    )
    return tree


def lora_param_count(lora: Params) -> int:
    count = 0

    def add(t):
        nonlocal count
        count += int(t.numel())
        return t

    tree_map(add, lora)
    return count


def merge_lora(params: Params, lora: Params, scaling: float) -> Params:
    """New params tree with every adapted kernel replaced by
    ``W + scaling · A@B`` (per layer, fp32); the input is untouched."""
    merged = tree_map(lambda t: t, params)  # new dicts, shared leaves
    for tower, tree in lora.items():
        for group_name, group in tree["blocks"].items():
            for proj, ab in group.items():
                base = merged[tower]["blocks"][group_name][proj]
                delta = scaling * torch.einsum(
                    "lir,lro->lio", ab["a"].float(), ab["b"].float()
                )
                base["kernel"] = base["kernel"].float() + delta.to(base["kernel"].device)
    return merged


def save_lora(path: str, lora: Params, cfg: LoraConfig) -> None:
    """Native format: npz weights + lora_config.json sidecar."""
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "lora_weights.npz"), lora)
    with open(os.path.join(path, "lora_config.json"), "w") as f:
        json.dump(
            {
                "r": cfg.r,
                "alpha": cfg.alpha,
                "dropout": cfg.dropout,
                "target_modules": list(cfg.target_modules),
                "base_model_name": cfg.base_model_name,
            },
            f,
        )


def load_lora(
    path: str, device: str | torch.device = "cuda", arch: ClipArchConfig | None = None
) -> tuple[Params, float]:
    """Load a native adapter dir (``lora_weights.npz`` + ``lora_config.json``)
    or, failing that, a PEFT adapter dir (``adapter_model.safetensors``,
    stacked to ``arch``'s depth, ViT-B/32 by default). Returns (tree, scaling)."""
    native = os.path.join(path, "lora_weights.npz")
    if os.path.exists(native):
        with open(os.path.join(path, "lora_config.json")) as f:
            meta = json.load(f)
        return load_params(native, device=device), meta["alpha"] / meta["r"]
    if os.path.exists(os.path.join(path, "adapter_model.safetensors")):
        from clip_lora_match_tpu_torch.lora.peft_io import load_peft_adapter

        return load_peft_adapter(path, arch=arch, device=device)
    raise FileNotFoundError(f"no LoRA adapter found under {path}")
