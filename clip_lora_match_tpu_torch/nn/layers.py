"""Functional NN building blocks for the CLIP towers (PyTorch port).

Port of ``clip_lora_match_tpu/nn/layers.py``: plain functions over nested
dicts of tensors, kernels as ``(in, out)``, transformer stacks with a leading
layer axis. Numerics kept: LayerNorm in fp32; quick-gelu; fp32 accumulation
in every matmul; under a bf16 ``compute_dtype`` the matmul output and the
bias/LoRA adds are bf16. LoRA adapters are ``{"a": (in, r), "b": (r, out)}``.

Kernel dispatch follows the same switches as the JAX package:
``fused_lora`` sends each adapted projection through ``ops.lora_matmul``
(an attention layer's q, k and v as one launch where the grouped operands of
``group_qkv`` are present);
``small_attention`` sends S <= ``SMALL_ATTN_MAX_SEQ`` (or causal
S <= ``SMALL_ATTN_CAUSAL_MAX_SEQ``) through ``ops.attention_small``;
``flash_attention`` sends the other sequences through
``ops.flash_attention``; ``fused_mlp`` sends each MLP without an fc1/fc2
adapter through ``ops.mlp_fused``.
Each switch is ``"auto"`` (the kernel branch for tensors on the card, the
exact plain path for CPU tensors; for ``flash_attention`` also only from
``FLASH_MIN_SEQ`` on), ``True`` (the kernel branch for every tensor; on the
CPU the wrapper runs the kernel's plain version) or ``False`` (the plain path
everywhere). The choice is made per call from the tensor's device, so
encoders on different devices never switch each other. ``fused_lora`` and
``small_attention`` default to ``"auto"``; ``flash_attention`` and
``fused_mlp`` default to ``False``, as in the JAX package.

Int8 (W8A8) weights (``quant/int8.py``: ``kernel_q`` int8, ``w_scale`` fp32)
take ``int8_matmul`` before any kernel branch: ``linear`` quantizes its input
as given, ``attention`` its compute-dtype input once for q/k/v together, and
the float LoRA deltas and biases are added after the dequantized product, as
in the JAX package. Under int8 neither ``lora_matmul`` nor ``mlp_fused``
runs; the attention core dispatches as on the float path.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

Params = dict[str, Any]

# Kernel-dispatch switches: "auto", True or False (see the module docstring).
_KERNEL_FLAGS = {
    "fused_lora": "auto",
    "flash_attention": False,
    "small_attention": "auto",
    "fused_mlp": False,
}

SMALL_ATTN_MAX_SEQ = 64
SMALL_ATTN_CAUSAL_MAX_SEQ = 80

# The JAX package's "auto" gate for flash attention, a TPU measurement that
# never picks it (flash lost to XLA's attention at every CLIP geometry there).
# Kept as the sentinel until the H100's own in-tower table is read; an
# explicit flash_attention=True forces the kernel.
FLASH_MIN_SEQ = 1 << 30


def set_kernel_flags(
    fused_lora: bool | str | None = None,
    flash_attention: bool | str | None = None,
    small_attention: bool | str | None = None,
    fused_mlp: bool | str | None = None,
) -> dict:
    """Set the process-wide kernel dispatch; returns the previous flags."""
    prev = dict(_KERNEL_FLAGS)
    for val in (fused_lora, flash_attention, small_attention, fused_mlp):
        if val not in (None, True, False, "auto"):
            raise ValueError(f"kernel flag must be True, False or 'auto', got {val!r}")
    for name, val in (
        ("fused_lora", fused_lora),
        ("flash_attention", flash_attention),
        ("small_attention", small_attention),
        ("fused_mlp", fused_mlp),
    ):
        if val is not None:
            _KERNEL_FLAGS[name] = val
    return prev


def get_kernel_flags() -> tuple:
    """Hashable snapshot of the dispatch flags."""
    return tuple(sorted(_KERNEL_FLAGS.items()))


@contextlib.contextmanager
def kernel_flags(**flags):
    """``set_kernel_flags`` for the body of a ``with``; the previous flags
    come back on exit."""
    prev = set_kernel_flags(**flags)
    try:
        yield
    finally:
        _KERNEL_FLAGS.update(prev)


def _kernel_on(name: str, x: torch.Tensor) -> bool:
    flag = _KERNEL_FLAGS[name]
    return flag is True or (flag == "auto" and x.is_cuda)


def _use_flash(x: torch.Tensor) -> bool:
    """``True`` forces flash; ``"auto"`` takes it for CUDA tensors from
    ``FLASH_MIN_SEQ`` on; ``False`` never."""
    flag = _KERNEL_FLAGS["flash_attention"]
    if flag == "auto":
        return x.is_cuda and x.shape[1] >= FLASH_MIN_SEQ
    return bool(flag)


def uses_small_attention(x: torch.Tensor, causal: bool = False) -> bool:
    """Whether ``attention`` on ``x`` (B, S, D) takes the small-attention
    kernel branch, which builds a causal mask itself and reads no additive one."""
    S = x.shape[1]
    return _kernel_on("small_attention", x) and (
        S <= SMALL_ATTN_MAX_SEQ or (causal and S <= SMALL_ATTN_CAUSAL_MAX_SEQ)
    )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32, cast back to the input dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _lora_delta(x: torch.Tensor, lora: Params, scaling: float) -> torch.Tensor:
    """scaling · round(x @ a) @ b in fp32 (the adapter branch of ``linear``)."""
    a = lora["a"].to(x.dtype)
    b = lora["b"].to(x.dtype)
    xa = (x.float() @ a.float()).to(x.dtype)
    return scaling * (xa.float() @ b.float())


def linear(
    p: Params,
    x: torch.Tensor,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """y = x @ kernel + bias [+ lora_scaling · (x @ a) @ b], in x's dtype."""
    out_dtype = x.dtype
    if "kernel_q" in p:
        from clip_lora_match_tpu_torch.quant.int8 import int8_matmul

        y = int8_matmul(x, p["kernel_q"], p["w_scale"])
        if lora is not None:
            y = y + _lora_delta(x, lora, lora_scaling)
        if p.get("bias") is not None:
            y = y + p["bias"].to(y.dtype)
        return y.to(out_dtype)
    w = p["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    bias = p.get("bias")
    if lora is not None and _kernel_on("fused_lora", x):
        from clip_lora_match_tpu_torch.ops.lora_matmul import lora_matmul

        shape = x.shape
        y = lora_matmul(
            x.reshape(-1, shape[-1]), w, lora["a"].to(x.dtype), lora["b"].to(x.dtype),
            scaling=float(lora_scaling),
        ).reshape(*shape[:-1], w.shape[-1])
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.to(out_dtype)
    acc_dtype = torch.float32 if compute_dtype is None else compute_dtype
    # a matmul of two bf16 tensors accumulates in fp32 and rounds its output
    # once: the JAX package's dot with preferred_element_type=bf16
    y = torch.matmul(x, w).to(acc_dtype)
    if lora is not None:
        y = y + _lora_delta(x, lora, lora_scaling).to(acc_dtype)
    if bias is not None:
        y = y + bias.to(acc_dtype)
    return y.to(out_dtype)


def _lora_get(block: Optional[Params], name: str) -> Optional[Params]:
    return None if block is None else block.get(name)


QKV = ("q_proj", "k_proj", "v_proj")


def group_qkv(p: Params, lora: Optional[Params], dtype: Optional[torch.dtype] = None) -> Optional[Params]:
    """The operands that run one attention layer's q, k and v projections as
    one ``lora_matmul`` launch with ``groups=3``: ``kernel`` [Wq | Wk | Wv]
    (D, 3D), ``a`` [Aq | Ak | Av] (D, 3r, the transposed view of a
    contiguous (3r, D) tensor, the kernel's layout), ``b``
    blockdiag(Bq, Bk, Bv) (3r, 3D; the zero blocks add exact zeros) and
    ``bias`` (3, 1, D) or None, the bias in ``dtype`` when given. None unless
    all three projections carry an adapter, the three ranks agree and the
    grouped rank 3r is one the kernel takes (``lora_matmul.R_MAX``)."""
    from clip_lora_match_tpu_torch.ops.lora_matmul import R_MAX

    if lora is None or any(lora.get(n) is None for n in QKV):
        return None
    ranks = {lora[n]["a"].shape[-1] for n in QKV}
    if len(ranks) != 1 or 3 * min(ranks) > R_MAX:
        return None
    r = ranks.pop()
    w = torch.cat([p[n]["kernel"] for n in QKV], dim=1)
    D = w.shape[1] // 3
    a = torch.cat([lora[n]["a"] for n in QKV], dim=1).t().contiguous().t()
    b = torch.zeros((3 * r, 3 * D), dtype=lora["q_proj"]["b"].dtype, device=w.device)
    for i, n in enumerate(QKV):
        b[i * r:(i + 1) * r, i * D:(i + 1) * D] = lora[n]["b"]
    biases = [p[n].get("bias") for n in QKV]
    bias = None
    if any(t is not None for t in biases):
        bias = torch.stack([torch.zeros(D, device=w.device) if t is None else t.float() for t in biases])
        bias = bias[:, None, :].to(dtype or torch.float32)
    return {"kernel": w, "a": a, "b": b, "bias": bias}


def int8_qkv(p: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """An int8 attention layer's q, k and v as one product's operands:
    ``kernel_q`` [Wq | Wk | Wv] (D, 3D) and ``w_scale`` (3D,). The serving
    copy holds them in ``p["qkv"]`` (``group_int8_qkv``); else they are
    concatenated per call."""
    if "qkv" in p:
        return p["qkv"]["kernel_q"], p["qkv"]["w_scale"]
    return (torch.cat([p[n]["kernel_q"] for n in QKV], dim=1),
            torch.cat([p[n]["w_scale"] for n in QKV]))


def group_int8_qkv(p: Params) -> None:
    """In an int8 attention layer: add ``p["qkv"]``, the concatenated
    operands of ``int8_qkv``, with ``kernel_q`` column-major, the layout
    ``torch._int_mm`` reads as the canonical int8 GEMM (K-contiguous
    operands), and make the q/k/v ``kernel_q`` column views of it."""
    wq, ws = int8_qkv(p)
    wq = wq.t().contiguous().t()
    p["qkv"] = {"kernel_q": wq, "w_scale": ws}
    D = wq.shape[1] // 3
    for i, n in enumerate(QKV):
        p[n] = {**p[n], "kernel_q": wq[:, i * D:(i + 1) * D]}


def attention(
    p: Params,
    x: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    causal: bool = False,
    key_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head self-attention with an optional additive mask.

    ``causal``/``key_lengths`` describe ``mask`` structurally; the small
    attention kernel rebuilds it from them, so ``mask`` may be None where
    ``uses_small_attention`` holds. Without an adapter (or with
    ``fused_lora`` off) q/k/v run as one fused (D, 3D) matmul and the LoRA
    deltas are added per projection; with an adapter and ``fused_lora`` on,
    q/k/v run as one ``lora_matmul`` on the grouped operands
    ``lora["qkv"]`` (``group_qkv``; the encoder's serving copy builds them)
    where present, else each projection runs ``lora_matmul``.
    """
    B, S, D = x.shape
    H = num_heads
    hd = D // H
    kw = dict(lora_scaling=lora_scaling, compute_dtype=compute_dtype)
    xc = x if compute_dtype is None else x.to(compute_dtype)
    quantized = "kernel_q" in p["q_proj"]
    group = None if quantized else _lora_get(lora, "qkv")
    if group is not None and _kernel_on("fused_lora", x):
        from clip_lora_match_tpu_torch.ops.lora_matmul import lora_matmul

        qkv = lora_matmul(
            xc.reshape(-1, D), group["kernel"], group["a"], group["b"],
            scaling=float(lora_scaling), groups=3,
        )
        if group["bias"] is not None:
            qkv = qkv + group["bias"].to(qkv.dtype)
        q, k, v = qkv.to(x.dtype).unbind(0)
    elif lora is not None and not quantized and _kernel_on("fused_lora", x):
        # x is cast once for the three projections
        q, k, v = (linear(p[n], xc, _lora_get(lora, n), **kw).to(x.dtype) for n in QKV)
    else:
        if quantized:
            # one per-token quantization of xc feeds the three projections
            from clip_lora_match_tpu_torch.quant.int8 import int8_matmul

            qkv = int8_matmul(xc, *int8_qkv(p))
        else:
            acc_dtype = torch.float32 if compute_dtype is None else compute_dtype
            w_qkv = group["kernel"] if group is not None else torch.cat([p[n]["kernel"] for n in QKV], dim=1)
            if compute_dtype is not None:
                w_qkv = w_qkv.to(compute_dtype)
            qkv = torch.matmul(xc, w_qkv).to(acc_dtype)
        biases = [p[n].get("bias") for n in QKV]
        if any(b is not None for b in biases):
            parts = [
                b if b is not None else torch.zeros(D, device=x.device) for b in biases
            ]
            qkv = qkv + torch.cat(parts).to(qkv.dtype)
        q, k, v = qkv.split(D, dim=-1)
        out = []
        for name, t in zip(QKV, (q, k, v)):
            lp = _lora_get(lora, name)
            if lp is not None:
                t = t + _lora_delta(xc, lp, lora_scaling).to(qkv.dtype)
            out.append(t.to(x.dtype))
        q, k, v = out

    qh = q.reshape(B, S, H, hd)
    kh = k.reshape(B, S, H, hd)
    vh = v.reshape(B, S, H, hd)
    if uses_small_attention(x, causal):
        from clip_lora_match_tpu_torch.ops.attention_small import attention_small

        if causal:
            ctx = attention_small(
                qh, kh, vh, scale=hd ** -0.5, causal=True, lengths=key_lengths
            )
        else:
            ctx = attention_small(qh, kh, vh, mask=mask, scale=hd ** -0.5)
    elif _use_flash(x):
        from clip_lora_match_tpu_torch.ops.flash_attention import flash_attention

        ctx = flash_attention(qh, kh, vh, mask=mask, scale=hd ** -0.5)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", (qh * hd ** -0.5).float(), kh.float())
        if mask is not None:
            scores = scores + mask.float()
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vh.float())
    ctx = ctx.to(x.dtype).reshape(B, S, D)
    return linear(p["out_proj"], ctx, _lora_get(lora, "out_proj"), **kw)


def mlp(
    p: Params,
    x: torch.Tensor,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    # fc1 -> quick-gelu -> fc2 in one kernel when neither matrix carries an
    # adapter and both have plain weights and biases (the kernel's signature;
    # int8 weights carry kernel_q, not kernel, and keep the linear path)
    if (
        _kernel_on("fused_mlp", x)
        and _lora_get(lora, "fc1") is None
        and _lora_get(lora, "fc2") is None
        and "kernel" in p["fc1"]
        and "kernel" in p["fc2"]
        and p["fc1"].get("bias") is not None
        and p["fc2"].get("bias") is not None
    ):
        from clip_lora_match_tpu_torch.ops.mlp_fused import mlp_fused

        shape = x.shape
        xc = x if compute_dtype is None else x.to(compute_dtype)
        w1, w2 = p["fc1"]["kernel"].to(xc.dtype), p["fc2"]["kernel"].to(xc.dtype)
        y = mlp_fused(xc.reshape(-1, shape[-1]), w1, p["fc1"]["bias"], w2, p["fc2"]["bias"])
        return y.reshape(*shape[:-1], w2.shape[-1]).to(x.dtype)
    kw = dict(lora_scaling=lora_scaling, compute_dtype=compute_dtype)
    h = quick_gelu(linear(p["fc1"], x, _lora_get(lora, "fc1"), **kw))
    return linear(p["fc2"], h, _lora_get(lora, "fc2"), **kw)


def transformer_block(
    p: Params,
    x: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    eps: float = 1e-5,
    compute_dtype: Optional[torch.dtype] = None,
    causal: bool = False,
    key_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pre-LN residual block: LN → attn → +res; LN → MLP → +res."""
    x = x + attention(
        p["attn"], layer_norm(p["ln_1"], x, eps), num_heads, mask=mask,
        lora=_lora_get(lora, "attn"), lora_scaling=lora_scaling,
        compute_dtype=compute_dtype, causal=causal, key_lengths=key_lengths,
    )
    x = x + mlp(
        p["mlp"], layer_norm(p["ln_2"], x, eps), lora=_lora_get(lora, "mlp"),
        lora_scaling=lora_scaling, compute_dtype=compute_dtype,
    )
    return x


def stack_blocks(block_list: list[Params]) -> Params:
    """List of per-layer trees → one tree with a leading layer axis on every
    leaf (the JAX package's scan layout); leaves may be tensors or arrays."""
    first = block_list[0]
    if isinstance(first, dict):
        return {k: stack_blocks([b[k] for b in block_list]) for k in first}
    return torch.stack([torch.as_tensor(t) for t in block_list])


def unstack_blocks(blocks) -> list[Params]:
    """Stacked tree (leading layer axis on every leaf) → list of per-layer
    trees (views, no copies). A list passes through unchanged."""
    if isinstance(blocks, list):
        return blocks

    def leaf0(t):
        return leaf0(next(iter(t.values()))) if isinstance(t, dict) else t

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]

    return [take(blocks, i) for i in range(leaf0(blocks).shape[0])]


def transformer(
    blocks,
    x: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    lora_blocks=None,
    lora_scaling: float = 1.0,
    eps: float = 1e-5,
    compute_dtype: Optional[torch.dtype] = None,
    causal: bool = False,
    key_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run a layer stack: a Python loop over the leading layer axis.
    ``blocks``/``lora_blocks`` are stacked trees or per-layer lists."""
    layers = unstack_blocks(blocks)
    lora_layers = unstack_blocks(lora_blocks) if lora_blocks is not None else None
    for i, blk in enumerate(layers):
        x = transformer_block(
            blk, x, num_heads, mask=mask,
            lora=None if lora_layers is None else lora_layers[i],
            lora_scaling=lora_scaling, eps=eps, compute_dtype=compute_dtype,
            causal=causal, key_lengths=key_lengths,
        )
    return x
