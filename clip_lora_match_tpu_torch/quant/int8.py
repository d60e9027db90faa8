"""Int8 (W8A8) serving path for the CLIP towers (port of ``quant/int8.py``).

An int8 tree is derived once from the fp32 params; ``nn.layers.linear`` and
``attention`` dispatch on ``kernel_q``, so the towers and the LoRA composition
are untouched (the adapter delta stays float, added after the dequantized
base output: adapters stay exact).

Scheme (dynamic W8A8, serving only):
- weights: symmetric per-output-channel scale ``s_w = max|W[:, o]| / 127``,
  ``wq = round(W / s_w)``;
- activations: symmetric per-token (row) scale computed per call,
  ``s_x = max|x| · (1 / 127)``, ``xq = round(x / s_x)``;
- ``y = (xq · wq) · (s_x ⊗ s_w) + b``: the int8 product accumulates in int32,
  the two scales are multiplied first, then the product is scaled.

That order (a division for ``s_w``, a product for ``s_x``, the scales
multiplied before the product, rounding half to even) is the JAX package's,
and keeps the port's codes and outputs bit-equal to it on the same inputs.

The int8 product is ``torch._int_mm`` on both devices (exact int32). The JAX
package computes it with ``lax.dot_general`` outside any Pallas kernel, so it
is a library call here, not a hand-written kernel. On CUDA ``_int_mm`` takes
more than 16 rows and K and N that are multiples of 8: a smaller block is
padded with zero rows, and every CLIP width is such a multiple. The
quantize and dequantize steps are plain PyTorch elementwise ops around it.

What stays float: the patch embedding and final projections, LayerNorms,
the attention core and L2 normalization.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

# linears inside a transformer block that get quantized
_BLOCK_LINEARS = (
    ("attn", "q_proj"),
    ("attn", "k_proj"),
    ("attn", "v_proj"),
    ("attn", "out_proj"),
    ("mlp", "fc1"),
    ("mlp", "fc2"),
)

# torch._int_mm on CUDA takes more than 16 rows
_CUDA_MIN_ROWS = 17


def quantize_linear_params(p: Params) -> Params:
    """{kernel (in, out), bias?} → {kernel_q int8, w_scale fp32 (out,), bias?}.

    Symmetric per output channel; a stacked (layer-leading) kernel quantizes
    per (layer, out) pair."""
    w = p["kernel"].float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    # a true division, as JAX's: CUDA divides by a Python scalar as a product
    # with its reciprocal, which rounds some scales one ulp apart
    s_w = amax.clamp_min(1e-8) / amax.new_full((), 127.0)
    wq = torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8)
    out = {"kernel_q": wq, "w_scale": s_w.squeeze(-2)}
    if p.get("bias") is not None:
        out["bias"] = p["bias"]
    return out


def dequantize_linear_params(qp: Params) -> Params:
    """Inverse of ``quantize_linear_params`` (up to rounding), for tests."""
    out = {"kernel": qp["kernel_q"].float() * qp["w_scale"][..., None, :]}
    if qp.get("bias") is not None:
        out["bias"] = qp["bias"]
    return out


def quantize_clip_params(params: Params) -> Params:
    """CLIP param tree → a tree with int8 transformer-block linears (new
    dicts; every other leaf, the patch embedding, embeddings, LayerNorms,
    projections and logit scale, is shared with ``params``)."""
    q = dict(params)
    for tower in ("visual", "text"):
        t = dict(params[tower])
        blocks = dict(params[tower]["blocks"])
        for grp, name in _BLOCK_LINEARS:
            blocks[grp] = dict(blocks[grp])
            blocks[grp][name] = quantize_linear_params(params[tower]["blocks"][grp][name])
        t["blocks"] = blocks
        q[tower] = t
    return q


def is_quantized(p: Params) -> bool:
    return "kernel_q" in p


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float → (xq (M, K) int8, s_x (M, 1) fp32): the per-token scale
    and codes. The abs-max is exact in x's own type, and ``x / s_x`` is
    computed in fp32 for any input type."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    s_x = amax.clamp_min(1e-8) * (1.0 / 127.0)
    return torch.div(x, s_x).round_().to(torch.int8), s_x


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (K, N) int8 → (M, N) int32, exact. ``int8_mm.calls``
    counts the products on either device."""
    int8_mm.calls += 1
    M = xq.shape[0]
    if xq.is_cuda and M < _CUDA_MIN_ROWS:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, _CUDA_MIN_ROWS - M))
    return torch._int_mm(xq, wq)[:M]


int8_mm.calls = 0


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Per-token activation quant + int8 product + fp32 dequant.

    x: (..., in) float; wq: (in, out) int8; w_scale: (out,) fp32.
    Returns (..., out) fp32."""
    shape = x.shape
    xq, s_x = quantize_rows(x.reshape(-1, shape[-1]))
    yi = int8_mm(xq, wq)
    return torch.mul(yi, s_x * w_scale).reshape(*shape[:-1], wq.shape[-1])
