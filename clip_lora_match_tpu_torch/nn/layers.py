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

Training (the JAX package's training branches): LoRA dropout on the adapter
input of every adapted projection, its masks drawn from a
``torch.Generator`` (``_keep``); an active dropout bypasses
``lora_matmul``, as in the JAX package. ``transformer`` draws one seed a
layer from its generator and each block draws its masks from a device
generator seeded with it, in a fixed order, so a checkpointed block redraws
the same masks when it is recomputed. Two more switches, both ``False`` by
default as in the JAX package: ``fused_lora_dropout`` gives q, k and v one
shared dropout mask in an autograd Function that redraws the mask in its
backward from the generator state it saved (``_QkvLoraShared``), and
``fast_ln`` runs LayerNorm as an autograd Function that saves only its input
and scale (``_FastLayerNorm``). ``transformer(remat=...)``: False, True
(each block under ``torch.utils.checkpoint``) or ``"dots"`` (selective
checkpointing that saves the products without batch dimensions, the linear
layers' ``mm``s, and recomputes the rest).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Optional

import torch

Params = dict[str, Any]

# Kernel-dispatch switches: "auto", True or False (see the module docstring).
_KERNEL_FLAGS = {
    "fused_lora": "auto",
    "flash_attention": False,
    "small_attention": "auto",
    "fused_mlp": False,
    "fused_lora_dropout": False,
    "fast_ln": False,
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
    fused_lora_dropout: bool | None = None,
    fast_ln: bool | None = None,
) -> dict:
    """Set the process-wide kernel dispatch; returns the previous flags.
    ``fused_lora_dropout`` and ``fast_ln`` take True or False."""
    prev = dict(_KERNEL_FLAGS)
    kernels = (
        ("fused_lora", fused_lora),
        ("flash_attention", flash_attention),
        ("small_attention", small_attention),
        ("fused_mlp", fused_mlp),
    )
    switches = (("fused_lora_dropout", fused_lora_dropout), ("fast_ln", fast_ln))
    for name, val in kernels:
        if val not in (None, True, False, "auto"):
            raise ValueError(f"kernel flag {name} must be True, False or 'auto', got {val!r}")
    for name, val in switches:
        if val not in (None, True, False):
            raise ValueError(f"flag {name} must be True or False, got {val!r}")
    for name, val in kernels + switches:
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
    """LayerNorm computed in fp32, cast back to the input dtype. Under
    ``fast_ln`` and autograd it runs as ``_FastLayerNorm``."""
    if _KERNEL_FLAGS["fast_ln"] and torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, p["scale"], p["bias"])
    ):
        return _FastLayerNorm.apply(x, p["scale"], p["bias"], eps)
    return _ln_plain(x, p["scale"], p["bias"], eps)


def _ln_plain(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


class _FastLayerNorm(torch.autograd.Function):
    """LayerNorm whose only saved tensors are its input and scale: mean,
    rstd and x-hat are recomputed in the backward, the JAX package's
    ``_ln_fast_bwd`` (``nn/layers.py:150-183``). The scale and bias
    gradients are computed only where they are asked for."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _ln_plain(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = (x32 - mu) * rstd
        dy32 = dy.float()
        g = dy32 * scale.float()
        dx = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
        red = tuple(range(x.dim() - 1))
        dscale = (dy32 * xhat).sum(red).to(scale.dtype) if ctx.needs_input_grad[1] else None
        dbias = dy32.sum(red).to(scale.dtype) if ctx.needs_input_grad[2] else None
        return dx.to(x.dtype), dscale, dbias, None


def _keep(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout's keep mask at ``rate``: a uniform draw from ``gen``
    below 1 - rate, one per element of ``x``."""
    return torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate


def _masked(t: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """The kept elements of ``t`` scaled by 1 / (1 - rate), the others 0, in
    t's dtype (the JAX package's ``jnp.where(keep, x / (1 - rate), 0)``)."""
    return torch.where(keep, t / (1.0 - rate), torch.zeros((), dtype=t.dtype, device=t.device)).to(t.dtype)


def _dropping(lora_dropout: float, generator: Optional[torch.Generator]) -> bool:
    return lora_dropout > 0.0 and generator is not None


def _lora_delta(
    x: torch.Tensor, lora: Params, scaling: float, lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """scaling · round(drop(x) @ a) @ b in fp32 (the adapter branch of
    ``linear``; dropout only with a generator and a positive rate)."""
    a = lora["a"].to(x.dtype)
    b = lora["b"].to(x.dtype)
    if _dropping(lora_dropout, generator):
        x = _masked(x, _keep(x, lora_dropout, generator), lora_dropout)
    xa = (x.float() @ a.float()).to(x.dtype)
    return scaling * (xa.float() @ b.float())


def linear(
    p: Params,
    x: torch.Tensor,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """y = x @ kernel + bias [+ lora_scaling · (drop(x) @ a) @ b], in x's
    dtype. Dropout (``lora_dropout`` > 0 with a ``generator``) applies to
    the adapter's input only, and takes the plain path."""
    out_dtype = x.dtype
    if "kernel_q" in p:
        from clip_lora_match_tpu_torch.quant.int8 import int8_matmul

        y = int8_matmul(x, p["kernel_q"], p["w_scale"])
        if lora is not None:
            y = y + _lora_delta(x, lora, lora_scaling, lora_dropout, generator)
        if p.get("bias") is not None:
            y = y + p["bias"].to(y.dtype)
        return y.to(out_dtype)
    w = p["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    bias = p.get("bias")
    if lora is not None and _kernel_on("fused_lora", x) and not _dropping(lora_dropout, generator):
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
        y = y + _lora_delta(x, lora, lora_scaling, lora_dropout, generator).to(acc_dtype)
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


class _QkvLoraShared(torch.autograd.Function):
    """The three q/k/v LoRA deltas under ONE shared dropout mask (the JAX
    package's ``_qkv_lora_shared``, ``nn/layers.py:285-357``): x (B, S, D),
    a_cat [Aq | Ak | Av] (D, 3r), b_stk (3, r, D) → (B, S, 3, D) deltas in
    x's dtype. The forward keeps the generator's state from before its draw;
    the backward redraws the mask from that state (no mask or masked x is
    saved) and re-reads x."""

    @staticmethod
    def forward(ctx, x, a_cat, b_stk, generator, scaling, rate):
        ctx.state = generator.get_state()
        ctx.scaling, ctx.rate = scaling, rate
        ctx.save_for_backward(x, a_cat, b_stk)
        B, S, _ = x.shape
        xl = _masked(x, _keep(x, rate, generator), rate)
        d = (xl.float() @ a_cat.float()).to(x.dtype).reshape(B, S, 3, -1)
        out = scaling * torch.einsum("bstr,trd->bstd", d.float(), b_stk.float())
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, a_cat, b_stk = ctx.saved_tensors
        B, S, D = x.shape
        r = b_stk.shape[1]
        gen = torch.Generator(device=x.device)
        gen.set_state(ctx.state)
        keep = _keep(x, ctx.rate, gen)
        xl = _masked(x, keep, ctx.rate)
        g32 = g.to(x.dtype).float()
        d = (xl.float() @ a_cat.float()).to(x.dtype).reshape(B, S, 3, r)
        db = ctx.scaling * torch.einsum("bstr,bstd->trd", d.float(), g32)
        gd = (ctx.scaling * torch.einsum("bstd,trd->bstr", g32, b_stk.float())).to(x.dtype)
        gd = gd.reshape(B, S, 3 * r).float()
        da = torch.einsum("bsd,bsk->dk", xl.float(), gd)
        dxl = (gd @ a_cat.float().t()).to(x.dtype)
        dx = _masked(dxl, keep, ctx.rate)
        return dx, da.to(a_cat.dtype), db.to(b_stk.dtype), None, None, None


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
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
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

    LoRA dropout (``lora_dropout`` > 0 with a ``generator``) takes the
    plain branch: each adapter's input gets its own mask, drawn in the order
    q, k, v, out_proj, or q, k and v share one (``fused_lora_dropout``, all
    three adapted with one rank).
    """
    B, S, D = x.shape
    H = num_heads
    hd = D // H
    kw = dict(lora_scaling=lora_scaling, compute_dtype=compute_dtype,
              lora_dropout=lora_dropout, generator=generator)
    xc = x if compute_dtype is None else x.to(compute_dtype)
    quantized = "kernel_q" in p["q_proj"]
    dropping = lora is not None and _dropping(lora_dropout, generator)
    kernel_lora = not quantized and not dropping and _kernel_on("fused_lora", x)
    group = None if quantized else _lora_get(lora, "qkv")
    if group is not None and kernel_lora:
        from clip_lora_match_tpu_torch.ops.lora_matmul import lora_matmul

        qkv = lora_matmul(
            xc.reshape(-1, D), group["kernel"], group["a"], group["b"],
            scaling=float(lora_scaling), groups=3,
        )
        if group["bias"] is not None:
            qkv = qkv + group["bias"].to(qkv.dtype)
        q, k, v = qkv.to(x.dtype).unbind(0)
    elif lora is not None and kernel_lora:
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
        adapters = [_lora_get(lora, n) for n in QKV]
        shared = (
            dropping and _KERNEL_FLAGS["fused_lora_dropout"]
            and all(lp is not None for lp in adapters)
            and len({tuple(lp["a"].shape) for lp in adapters}) == 1
        )
        if shared:
            a_cat = torch.cat([lp["a"] for lp in adapters], dim=1).to(xc.dtype)
            b_stk = torch.stack([lp["b"] for lp in adapters]).to(xc.dtype)
            deltas = _QkvLoraShared.apply(
                xc, a_cat, b_stk, generator, float(lora_scaling), float(lora_dropout)
            )
            qkv = qkv + deltas.reshape(B, S, 3 * D).to(qkv.dtype)
            adapters = [None, None, None]
        out = []
        for lp, t in zip(adapters, qkv.split(D, dim=-1)):
            if lp is not None:
                t = t + _lora_delta(xc, lp, lora_scaling, lora_dropout, generator).to(qkv.dtype)
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
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
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
    kw = dict(lora_scaling=lora_scaling, compute_dtype=compute_dtype,
              lora_dropout=lora_dropout, generator=generator)
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
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Pre-LN residual block: LN → attn → +res; LN → MLP → +res. The
    attention's dropout masks are drawn from ``generator`` before the
    MLP's."""
    x = x + attention(
        p["attn"], layer_norm(p["ln_1"], x, eps), num_heads, mask=mask,
        lora=_lora_get(lora, "attn"), lora_scaling=lora_scaling,
        compute_dtype=compute_dtype, causal=causal, key_lengths=key_lengths,
        lora_dropout=lora_dropout, generator=generator,
    )
    x = x + mlp(
        p["mlp"], layer_norm(p["ln_2"], x, eps), lora=_lora_get(lora, "mlp"),
        lora_scaling=lora_scaling, compute_dtype=compute_dtype,
        lora_dropout=lora_dropout, generator=generator,
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


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's "dots": keep the outputs of the products
    without batch dimensions (the linear layers' ``mm``/``addmm``; the JAX
    package's ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_block(block_fn, x, remat):
    if not remat:
        return block_fn(x)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    elif remat is not True:
        raise ValueError(f"remat must be False, True or 'dots', got {remat!r}")
    # the dropout masks come from generators the block seeds itself, not from
    # the global RNG, so there is no RNG state to stash
    return checkpoint(block_fn, x, use_reentrant=False, preserve_rng_state=False, **kw)


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
    remat: bool | str = False,
    lora_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Run a layer stack: a Python loop over the leading layer axis.
    ``blocks``/``lora_blocks`` are stacked trees or per-layer lists.

    With LoRA dropout (``lora_dropout`` > 0, a ``generator`` and adapters)
    one seed a layer is drawn from ``generator`` first; each block seeds a
    generator on x's device with its own and draws its masks from it, so a
    block recomputed under ``remat`` draws the same ones. ``remat``: False
    keeps every activation for the backward; True checkpoints each block;
    ``"dots"`` checkpoints each block but keeps its linear products."""
    layers = unstack_blocks(blocks)
    lora_layers = unstack_blocks(lora_blocks) if lora_blocks is not None else None
    seeds = [None] * len(layers)
    if lora_layers is not None and _dropping(lora_dropout, generator):
        seeds = torch.randint(
            0, 2 ** 62, (len(layers),), generator=generator, device=generator.device
        ).tolist()
    for i, blk in enumerate(layers):
        def block_fn(h, blk=blk, lb=None if lora_layers is None else lora_layers[i], seed=seeds[i]):
            gen = None if seed is None else torch.Generator(device=h.device).manual_seed(seed)
            return transformer_block(
                blk, h, num_heads, mask=mask, lora=lb, lora_scaling=lora_scaling, eps=eps,
                compute_dtype=compute_dtype, causal=causal, key_lengths=key_lengths,
                lora_dropout=lora_dropout, generator=gen,
            )

        x = _run_block(block_fn, x, remat)
    return x
