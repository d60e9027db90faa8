"""CLIP dual-tower model in functional PyTorch (port of ``models/clip.py``).

Parameters are a nested dict of tensors in the JAX package's layout (stacked
transformer layers, ``(in, out)`` kernels), so a tree written by the JAX
package loads unchanged through ``models/io.params_from_numpy``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.config import ClipArchConfig
from clip_lora_match_tpu_torch.nn.layers import (
    layer_norm,
    linear,
    transformer,
    uses_small_attention,
)

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initialization (numpy, seeded; same shapes and scales as the JAX package)
# ---------------------------------------------------------------------------


def _normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def _init_ln(d: int, layers: int) -> Params:
    return {
        "scale": np.ones((layers, d), np.float32),
        "bias": np.zeros((layers, d), np.float32),
    }


def _init_linear(rng, layers, d_in, d_out, std) -> Params:
    return {
        "kernel": _normal(rng, (layers, d_in, d_out), std),
        "bias": np.zeros((layers, d_out), np.float32),
    }


def _init_blocks(rng, width: int, mlp_dim: int, n_layers: int) -> Params:
    """Stacked blocks, CLIP-paper init: attn std w^-0.5, proj std by depth."""
    attn_std = width ** -0.5
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    fc_std = (2 * width) ** -0.5
    L = n_layers
    return {
        "ln_1": _init_ln(width, L),
        "attn": {
            "q_proj": _init_linear(rng, L, width, width, attn_std),
            "k_proj": _init_linear(rng, L, width, width, attn_std),
            "v_proj": _init_linear(rng, L, width, width, attn_std),
            "out_proj": _init_linear(rng, L, width, width, proj_std),
        },
        "ln_2": _init_ln(width, L),
        "mlp": {
            "fc1": _init_linear(rng, L, width, mlp_dim, fc_std),
            "fc2": _init_linear(rng, L, mlp_dim, width, proj_std),
        },
    }


def init_params(
    seed: int = 0, arch: ClipArchConfig | None = None, device: str | torch.device = "cuda"
) -> Params:
    """Random CLIP parameter tree (ViT-B/32 by default), drawn with numpy from
    ``seed`` on the host and moved to ``device`` as fp32 tensors."""
    from clip_lora_match_tpu_torch.core.device import resolve_device
    from clip_lora_match_tpu_torch.models.io import to_device

    dev = resolve_device(device)
    arch = arch or ClipArchConfig()
    rng = np.random.default_rng(seed)
    patch_dim = arch.patch_size * arch.patch_size * 3
    vw, tw = arch.vision_width, arch.text_width
    ln = lambda d: {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}
    tree = {
        "visual": {
            "patch_embed": {"kernel": _normal(rng, (patch_dim, vw), vw ** -0.5)},
            "class_embedding": _normal(rng, (vw,), vw ** -0.5),
            "pos_embedding": _normal(rng, (arch.vision_seq_len, vw), 0.01),
            "ln_pre": ln(vw),
            "blocks": _init_blocks(rng, vw, arch.vision_mlp_dim, arch.vision_layers),
            "ln_post": ln(vw),
            "proj": {"kernel": _normal(rng, (vw, arch.projection_dim), vw ** -0.5)},
        },
        "text": {
            "token_embedding": _normal(rng, (arch.vocab_size, tw), 0.02),
            "pos_embedding": _normal(rng, (arch.max_text_length, tw), 0.01),
            "blocks": _init_blocks(rng, tw, arch.text_mlp_dim, arch.text_layers),
            "ln_final": ln(tw),
            "proj": {"kernel": _normal(rng, (tw, arch.projection_dim), tw ** -0.5)},
        },
        "logit_scale": np.asarray(arch.logit_scale_init, np.float32),
    }
    return to_device(tree, dev, torch.float32)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) NHWC → (B, (H/p)*(W/p), 3*p*p) patch rows, channel-major
    inside the patch (the Conv2d weight layout (C, ph, pw) flattened)."""
    B, H, W, C = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, ph, pw)
    return x.reshape(B, gh * gw, C * patch * patch)


def encode_image_features(
    params: Params,
    pixel_values: torch.Tensor,
    arch: ClipArchConfig,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool | str = False,
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    unroll: int | bool = 1,
) -> torch.Tensor:
    """(B, H, W, 3) → (B, projection_dim) un-normalized image features.

    ``remat``, ``lora_dropout`` and ``generator`` go to ``nn.layers.transformer``
    (dropout only with a generator). ``unroll`` is the JAX package's scan
    unroll, accepted and without effect: the layers run as a Python loop."""
    p = params["visual"]
    x = _patchify(pixel_values, arch.patch_size)
    x = linear(p["patch_embed"], x, compute_dtype=compute_dtype)
    cls = p["class_embedding"].to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + p["pos_embedding"].to(x.dtype)
    x = layer_norm(p["ln_pre"], x, arch.layer_norm_eps)
    x = transformer(
        p["blocks"], x, arch.vision_heads,
        lora_blocks=None if lora is None else lora["visual"]["blocks"],
        lora_scaling=lora_scaling, eps=arch.layer_norm_eps,
        compute_dtype=compute_dtype, remat=remat, lora_dropout=lora_dropout,
        generator=generator,
    )
    pooled = layer_norm(p["ln_post"], x[:, 0], arch.layer_norm_eps)
    return linear(p["proj"], pooled, compute_dtype=compute_dtype)


def _text_mask(attention_mask: Optional[torch.Tensor], S: int, device) -> torch.Tensor:
    """Additive causal (+ padding) mask, (B|1, 1, S, S) fp32."""
    neg = torch.finfo(torch.float32).min
    causal = torch.triu(torch.full((S, S), neg, device=device), diagonal=1)[None, None]
    if attention_mask is None:
        return causal
    pad = (1.0 - attention_mask.float())[:, None, None, :] * neg
    return causal + pad


def encode_text_features(
    params: Params,
    input_ids: torch.Tensor,
    arch: ClipArchConfig,
    attention_mask: Optional[torch.Tensor] = None,
    eot_id: Optional[int] = None,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool | str = False,
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    unroll: int | bool = 1,
) -> torch.Tensor:
    """(B, S) int ids → (B, projection_dim) un-normalized text features.

    Pools the hidden state at the FIRST EOT position (argmax of
    ``ids == eot_id``; argmax of ids when ``eot_id`` is None).
    ``attention_mask`` rows must be suffix-padded; the structural
    description handed to the small attention kernel is causal + per-row key
    lengths ``mask.sum(-1)``. ``remat``, ``lora_dropout``, ``generator``
    and ``unroll`` as in ``encode_image_features``.
    """
    p = params["text"]
    B, S = input_ids.shape
    x = p["token_embedding"][input_ids.long()]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = x + p["pos_embedding"][:S].to(x.dtype)
    # the small attention kernel rebuilds the mask from causal + key_lengths
    mask = None if uses_small_attention(x, causal=True) else _text_mask(attention_mask, S, x.device)
    key_lengths = (
        None if attention_mask is None else attention_mask.to(torch.int32).sum(-1)
    )
    x = transformer(
        p["blocks"], x, arch.text_heads, mask=mask,
        lora_blocks=None if lora is None else lora["text"]["blocks"],
        lora_scaling=lora_scaling, eps=arch.layer_norm_eps,
        compute_dtype=compute_dtype, causal=True, key_lengths=key_lengths,
        remat=remat, lora_dropout=lora_dropout, generator=generator,
    )
    x = layer_norm(p["ln_final"], x, arch.layer_norm_eps)
    if eot_id is None:
        eot_pos = torch.argmax(input_ids, dim=-1)
    else:
        eot_pos = torch.argmax((input_ids == eot_id).to(torch.int32), dim=-1)
    pooled = x[torch.arange(B, device=x.device), eot_pos]
    return linear(p["proj"], pooled, compute_dtype=compute_dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = x32.square().sum(dim, keepdim=True).sqrt()
    return (x32 / n.clamp_min(eps)).to(x.dtype)
