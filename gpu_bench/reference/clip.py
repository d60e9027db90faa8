"""Plain fp32 CLIP towers with LoRA (Radford et al. 2021, arXiv:2103.00020;
LoRA: Hu et al. 2021, arXiv:2106.09685), written from the published
description in plain PyTorch.

Pre-LayerNorm transformer blocks, quick-GELU MLPs, multi-head attention
(causal in the text tower), LoRA on the attention projections as
``y = x W + b + (alpha / r) (x A) B``. The image tower embeds patches with a
convolution whose weight is the (3·p·p, width) kernel of the inputs read as
the (width, 3, p, p) filter bank, prepends the class token and pools it; the
text tower pools the first end token and runs all 77 positions. Every
product runs in fp32 with TF32 off (``fp32()``), or in TF32 as a control.
Imports nothing of the port.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32: bool = False):
    """fp32 products (TF32 off) for the body of a ``with``; ``tf32=True``
    computes them in TF32, the control's precision."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _proj(x, p, lo, scaling):
    y = x @ p["kernel"] + p["bias"]
    if lo is not None:
        y = y + scaling * ((x @ lo["a"]) @ lo["b"])
    return y


def _layer(tree, i):
    """Layer ``i`` of a tree of stacked layers."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block(x, p, lo, heads, eps, causal, scaling):
    B, S, W = x.shape
    h = _ln(x, p["ln_1"], eps)
    ad = (lo or {}).get("attn", {})
    q, k, v = (_proj(h, p["attn"][n], ad.get(n), scaling).view(B, S, heads, W // heads).transpose(1, 2)
               for n in ("q_proj", "k_proj", "v_proj"))
    scores = (q @ k.transpose(-1, -2)) / (W // heads) ** 0.5
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    att = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, S, W)
    x = x + _proj(att, p["attn"]["out_proj"], ad.get("out_proj"), scaling)
    h = _ln(x, p["ln_2"], eps)
    h = h @ p["mlp"]["fc1"]["kernel"] + p["mlp"]["fc1"]["bias"]
    h = h * torch.sigmoid(1.702 * h)
    return x + h @ p["mlp"]["fc2"]["kernel"] + p["mlp"]["fc2"]["bias"]


def _stack(x, blocks, lora_blocks, layers, heads, eps, causal, scaling):
    for i in range(layers):
        lo = None if lora_blocks is None else _layer(lora_blocks, i)
        x = _block(x, _layer(blocks, i), lo, heads, eps, causal, scaling)
    return x


def image_features(params, lora, pixels, w: dict, scaling: float) -> torch.Tensor:
    """(B, H, W, 3) CLIP-normalized fp32 pixels → (B, projection) features."""
    p = params["visual"]
    ps, vw = w["patch_size"], w["vision_width"]
    filt = p["patch_embed"]["kernel"].t().reshape(vw, 3, ps, ps)
    x = F.conv2d(pixels.permute(0, 3, 1, 2), filt, stride=ps).flatten(2).transpose(1, 2)
    cls = p["class_embedding"].expand(x.shape[0], 1, vw)
    x = torch.cat([cls, x], 1) + p["pos_embedding"]
    x = _ln(x, p["ln_pre"], w["layer_norm_eps"])
    x = _stack(x, p["blocks"], None if lora is None else lora["visual"]["blocks"], w["vision_layers"],
               w["vision_heads"], w["layer_norm_eps"], False, scaling)
    return _ln(x[:, 0], p["ln_post"], w["layer_norm_eps"]) @ p["proj"]["kernel"]


def text_features(params, lora, ids, w: dict, eot: int, scaling: float) -> torch.Tensor:
    """(B, 77) ids → (B, projection) features, pooled at the first end token."""
    p = params["text"]
    x = p["token_embedding"][ids] + p["pos_embedding"][: ids.shape[1]]
    x = _stack(x, p["blocks"], None if lora is None else lora["text"]["blocks"], w["text_layers"],
               w["text_heads"], w["layer_norm_eps"], True, scaling)
    x = _ln(x, p["ln_final"], w["layer_norm_eps"])
    pos = (ids == eot).int().argmax(-1)
    return x[torch.arange(ids.shape[0], device=ids.device), pos] @ p["proj"]["kernel"]


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
