"""HF ``CLIPModel`` state dict → the port's parameter tree (port of
``models/convert_hf.py``).

Takes a mapping of torch tensors or numpy arrays (a ``CLIPModel``'s
``state_dict()``, or one read from a checkpoint file); nothing here imports
``transformers``. Layout: torch ``Linear`` weights are (out, in) and the
tree's kernels (in, out), so they are transposed; the patch conv
(width, 3, p, p) flattens to (3*p*p, width), channel-major inside the patch
as ``models/clip._patchify`` expects; per-layer tensors are stacked along a
leading layer axis. Leaves are fp32 CPU tensors; ``ClipEncoder`` moves them.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Mapping

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.config import ClipArchConfig
from clip_lora_match_tpu_torch.nn.layers import stack_blocks

Params = dict[str, Any]


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _linear(sd: Mapping, prefix: str) -> Params:
    p = {"kernel": _t(sd[f"{prefix}.weight"]).T.contiguous()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _ln(sd: Mapping, prefix: str) -> Params:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _blocks(sd: Mapping, prefix: str, n_layers: int) -> Params:
    blocks = []
    for i in range(n_layers):
        b = f"{prefix}.layers.{i}"
        blocks.append({
            "ln_1": _ln(sd, f"{b}.layer_norm1"),
            "attn": {
                name: _linear(sd, f"{b}.self_attn.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "ln_2": _ln(sd, f"{b}.layer_norm2"),
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"), "fc2": _linear(sd, f"{b}.mlp.fc2")},
        })
    return stack_blocks(blocks)


def infer_arch_from_state_dict(
    sd: Mapping,
    vision_heads: int | None = None,
    text_heads: int | None = None,
) -> ClipArchConfig:
    """The full ``ClipArchConfig`` from an HF CLIPModel state dict.

    Head counts are not recoverable from shapes: pass them from the HF
    config's ``num_attention_heads`` when known; otherwise they follow the
    64-dims-per-head convention of every released CLIP, with a warning.
    """
    if vision_heads is None or text_heads is None:
        warnings.warn(
            "infer_arch_from_state_dict: head counts inferred by the "
            "64-dim-per-head convention (not recoverable from shapes). If "
            "this checkpoint's num_attention_heads differs, pass "
            "vision_heads/text_heads explicitly from its HF config.",
            stacklevel=2,
        )
    vw, _, ph, _ = tuple(sd["vision_model.embeddings.patch_embedding.weight"].shape)
    vis_pos = sd["vision_model.embeddings.position_embedding.weight"].shape
    image_size = int(round((vis_pos[0] - 1) ** 0.5)) * ph
    tok = tuple(sd["text_model.embeddings.token_embedding.weight"].shape)
    txt_pos = sd["text_model.embeddings.position_embedding.weight"].shape

    def n_layers(prefix):
        pat = re.compile(rf"{prefix}\.encoder\.layers\.(\d+)\.")
        return max(int(m.group(1)) for k in sd if (m := pat.match(k))) + 1

    return ClipArchConfig(
        image_size=image_size,
        patch_size=ph,
        vision_width=vw,
        vision_layers=n_layers("vision_model"),
        vision_heads=vision_heads if vision_heads is not None else max(1, vw // 64),
        vision_mlp_dim=sd["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        vocab_size=tok[0],
        max_text_length=txt_pos[0],
        text_width=tok[1],
        text_layers=n_layers("text_model"),
        text_heads=text_heads if text_heads is not None else max(1, tok[1] // 64),
        text_mlp_dim=sd["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        projection_dim=sd["text_projection.weight"].shape[0],
    )


def convert_hf_clip_state_dict(sd: Mapping, arch: ClipArchConfig | None = None) -> Params:
    """HF CLIPModel state dict (torch tensors or arrays) → the port's tree."""
    arch = arch or infer_arch_from_state_dict(sd)
    patch_w = _t(sd["vision_model.embeddings.patch_embedding.weight"])
    return {
        "visual": {
            "patch_embed": {"kernel": patch_w.reshape(patch_w.shape[0], -1).T.contiguous()},
            "class_embedding": _t(sd["vision_model.embeddings.class_embedding"]),
            "pos_embedding": _t(sd["vision_model.embeddings.position_embedding.weight"]),
            "ln_pre": _ln(sd, "vision_model.pre_layrnorm"),  # sic: HF's key
            "blocks": _blocks(sd, "vision_model.encoder", arch.vision_layers),
            "ln_post": _ln(sd, "vision_model.post_layernorm"),
            "proj": {"kernel": _t(sd["visual_projection.weight"]).T.contiguous()},
        },
        "text": {
            "token_embedding": _t(sd["text_model.embeddings.token_embedding.weight"]),
            "pos_embedding": _t(sd["text_model.embeddings.position_embedding.weight"]),
            "blocks": _blocks(sd, "text_model.encoder", arch.text_layers),
            "ln_final": _ln(sd, "text_model.final_layer_norm"),
            "proj": {"kernel": _t(sd["text_projection.weight"]).T.contiguous()},
        },
        "logit_scale": _t(sd["logit_scale"]),
    }


def convert_hf_clip_model(model, arch: ClipArchConfig | None = None) -> Params:
    """An HF CLIPModel instance → the port's tree; head counts come from the
    model's config (``num_attention_heads``), not the convention."""
    sd = model.state_dict()
    if arch is None:
        cfg = getattr(model, "config", None)
        vh = getattr(getattr(cfg, "vision_config", None), "num_attention_heads", None)
        th = getattr(getattr(cfg, "text_config", None), "num_attention_heads", None)
        arch = infer_arch_from_state_dict(sd, vision_heads=vh, text_heads=th)
    return convert_hf_clip_state_dict(sd, arch)
