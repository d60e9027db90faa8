"""Floating-point operations of the CLIP towers with LoRA, from shapes.

They count what the architecture needs, not what an implementation does:
the products of every linear layer (2 operations a multiply-add), LoRA's two
products on each adapted projection, and attention's two products over the
pairs the mask keeps (all of them in the image tower, the causal half in the
text tower). LayerNorm, softmax, activations and the optimizer are
elementwise and not counted. A text counts at its own token length, not at
the padded width an implementation runs. Nothing here imports the port.
"""

from __future__ import annotations


def _layer_linear(tokens: int, width: int, mlp: int, r: int, adapted: int) -> int:
    base = 8 * tokens * width * width + 4 * tokens * width * mlp
    lora = adapted * 4 * tokens * width * r
    return base + lora


def text_tower(w: dict, tokens: int, r: int, adapted: int = 4) -> int:
    """One text of ``tokens`` tokens through the text tower: every layer,
    causal attention over tokens·(tokens+1)/2 pairs, the projection of the
    pooled token."""
    tw, L = w["text_width"], w["text_layers"]
    layer = _layer_linear(tokens, tw, w["text_mlp_dim"], r, adapted)
    layer += 2 * tw * tokens * (tokens + 1)  # q·k and p·v over the causal pairs
    return L * layer + 2 * tw * w["projection_dim"]


def image_tokens(w: dict) -> int:
    return (w["image_size"] // w["patch_size"]) ** 2 + 1


def image_tower(w: dict, r: int, adapted: int = 4) -> int:
    """One image through the image tower: the patch embedding, every layer
    with full attention, the projection of the class token."""
    vw, L, S = w["vision_width"], w["vision_layers"], image_tokens(w)
    patch = 2 * (S - 1) * 3 * w["patch_size"] ** 2 * vw
    layer = _layer_linear(S, vw, w["vision_mlp_dim"], r, adapted) + 4 * S * S * vw
    return patch + L * layer + 2 * vw * w["projection_dim"]


def _tower_backward(tokens: int, width: int, mlp: int, layers: int, r: int, adapted: int,
                    pairs: int, proj: int) -> int:
    """The backward products a frozen tower with trained LoRA needs: the
    input gradient of every frozen product (none for the first layer's
    q/k/v, whose inputs reach nothing trained), twice attention's forward,
    and four products for each adapted projection (dB, d(xA), dA, dx; the
    first layer's q/k/v without dx)."""
    base = 8 * tokens * width * width + 4 * tokens * width * mlp
    attn = 2 * 4 * pairs * width  # forward: 4 operations a kept pair and channel
    lora = adapted * 8 * tokens * width * r
    total = layers * (base + attn + lora)
    total -= 3 * 2 * tokens * width * width + 3 * 2 * tokens * width * r
    return total + 2 * width * proj


def train_step(w: dict, token_lengths, batch: int, r: int, adapted: int = 4) -> int:
    """One contrastive step over ``batch`` image-caption pairs, the captions
    at ``token_lengths``: both towers forward and backward, and the loss's
    two products (B·B·projection) forward and twice backward."""
    S = image_tokens(w)
    fwd = batch * image_tower(w, r, adapted) + sum(text_tower(w, int(n), r, adapted) for n in token_lengths)
    bwd = batch * _tower_backward(S, w["vision_width"], w["vision_mlp_dim"], w["vision_layers"], r, adapted,
                                  S * S, w["projection_dim"])
    bwd += sum(_tower_backward(int(n), w["text_width"], w["text_mlp_dim"], w["text_layers"], r, adapted,
                               int(n) * (int(n) + 1) // 2, w["projection_dim"]) for n in token_lengths)
    loss = 3 * 2 * batch * batch * w["projection_dim"]
    return fwd + bwd + loss
