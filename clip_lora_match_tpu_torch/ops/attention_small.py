"""Whole-sequence small attention: CUDA kernel, plain version and wrapper.

Port of ``clip_lora_match_tpu/ops/attention_small.py``. q, k, v are
(B, S, H, hd) in the projection layout, untransposed. Softmax is the
max-free form ``exp(min(s, 80))`` normalized after P·V by
``max(sum, 1e-30)``: exact softmax for row logits in (-87, 80), zeros for a
fully masked row. Mask modes: none; structural (``causal`` and/or ``lengths``
(B,), rebuilt inside the kernel); or an additive ``mask`` broadcastable to
(B, 1, S, S). The kernel is ``csrc/attention_small.cu``.

The wrapper is differentiable in q, k and v: under autograd it runs as
``_AttentionSmall``, whose backward is the JAX package's ``custom_vjp``
backward (``ops/attention_small.py:358-367``): autograd through
``attention_reference`` (exact softmax) with the structural mask written
out as an additive one. The mask and the lengths take no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from clip_lora_match_tpu_torch.ops import _build

NEG_INF = torch.finfo(torch.float32).min
MAX_SEQ = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def struct_mask(
    causal: bool, lengths: Optional[torch.Tensor], S: int, device
) -> Optional[torch.Tensor]:
    """Additive (B|1, 1, S, S) fp32 mask equal to the structural mode."""
    out = None
    if causal:
        out = torch.triu(torch.full((S, S), NEG_INF, device=device), diagonal=1)[None, None]
    if lengths is not None:
        kcol = torch.arange(S, device=device)[None, None, None, :]
        pad = torch.where(
            kcol < lengths.to(device)[:, None, None, None],
            torch.zeros((), device=device), torch.full((), NEG_INF, device=device),
        )
        out = pad if out is None else out + pad
    return out


def attention_small_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (fp32 scores and P·V, P
    rounded to the input dtype before the P·V product, as the kernel does)."""
    B, S, H, hd = q.shape
    if scale is None:
        scale = float(hd) ** -0.5
    if mask is not None and (causal or lengths is not None):
        raise ValueError("pass EITHER an additive mask OR causal/lengths, not both")
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pen = mask.float() if mask is not None else struct_mask(causal, lengths, S, q.device)
    if pen is not None:
        scores = scores + pen
    e = torch.exp(torch.clamp(scores, max=80.0))
    ctx = torch.einsum("bhqk,bkhd->bqhd", e.to(q.dtype).float(), v.float())
    denom = e.sum(-1).clamp_min(1e-30).permute(0, 2, 1)[..., None]  # (B, S, H, 1)
    return (ctx / denom).to(q.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# attention_small_fwd(q, k, v, o, lengths, mask, mask_bstride, B, S, H, head_dim,
#                     scale, causal, dtype, warps_per_block, split, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P)
_KSPLIT = 4


def launch_shape(B: int, S: int, H: int, dtype, sms: int) -> tuple[int, int]:
    """(warps per block, split). A request (fewer heads than SMs) wants short
    chains and many blocks; a batch wants K and V staged as few times as it
    can. bf16: at a request a block takes 16 query rows and splits their keys
    across 4 warps (split 4); at a batch it takes every row of its head, one
    warp per 16 (split 1). fp32: 8 warps, 2 query rows a thread at a request,
    4 at a batch (split = rows a thread)."""
    request = B * H < sms
    if dtype == torch.float32:
        return 8, (2 if request else 4)
    return (_KSPLIT, _KSPLIT) if request else (-(-S // 16), 1)


def _launch(q, k, v, mask, scale, causal, lengths) -> torch.Tensor:
    B, S, H, hd = q.shape
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention_small: float32 or bfloat16 q/k/v, got {q.dtype}")
    if hd != 64 or S > MAX_SEQ:
        raise ValueError(f"attention_small kernel: head_dim 64 and S <= {MAX_SEQ}, got {q.shape}")
    if k.shape != q.shape or v.shape != q.shape or k.device != q.device or v.device != q.device:
        raise ValueError("attention_small: q, k, v must share shape and device")
    q, k, v = (t if t.is_contiguous() else t.contiguous() for t in (q, k, v))
    len_ptr, mask_ptr, mask_bstride = None, None, 0
    if lengths is not None:
        if lengths.dtype != torch.int32 or lengths.device != q.device or not lengths.is_contiguous():
            lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lengths.shape != (B,):
            raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
        len_ptr = lengths.data_ptr()
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32)
        nb = 1 if mask.shape[0] == 1 else B
        mask = mask.expand(nb, 1, S, S).contiguous()
        mask_ptr, mask_bstride = mask.data_ptr(), (0 if nb == 1 else S * S)
    out = torch.empty_like(q)
    warps, split = launch_shape(B, S, H, q.dtype, _build.sm_count(q.device))
    rc = _build.function("attention_small", "attention_small_fwd", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), len_ptr, mask_ptr,
        mask_bstride, B, S, H, hd, scale, int(causal), _DTYPES[q.dtype], warps, split,
        _build.stream_ptr(q),
    )
    _build.check(rc, "attention_small_fwd")
    attention_small.launches += 1
    return out


def attention_reference(q, k, v, mask, scale: float) -> torch.Tensor:
    """The JAX package's ``_reference``: q scaled in its own dtype, fp32
    scores plus the additive mask, exact fp32 softmax rounded to q's dtype,
    P·V accumulated in fp32 and cast to q's dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def attention_small_backward(q, k, v, g, mask, scale: float, causal: bool, lengths):
    """(dq, dk, dv) for the cotangent ``g``: the vjp of
    ``attention_reference`` under the additive form of the mask."""
    full = mask if mask is not None else struct_mask(causal, lengths, q.shape[1], q.device)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_reference(*leaves, full, scale)
        return torch.autograd.grad(out, leaves, g.to(q.dtype))


class _AttentionSmall(torch.autograd.Function):
    """The kernel (CUDA) or its plain version (CPU) forward; the JAX
    package's backward, recomputed from q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, lengths):
        ctx.save_for_backward(q, k, v, mask, lengths)
        ctx.scale, ctx.causal = scale, causal
        return _forward(q, k, v, mask, scale, causal, lengths)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, lengths = ctx.saved_tensors
        dq, dk, dv = attention_small_backward(q, k, v, g, mask, ctx.scale, ctx.causal, lengths)
        return dq, dk, dv, None, None, None, None


def _forward(q, k, v, mask, scale: float, causal: bool, lengths) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_small_plain(q, k, v, mask, scale, causal, lengths)
    return _launch(q, k, v, mask, scale, causal, lengths)


def attention_small(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, S, H, hd) context. CUDA tensors launch the kernel; CPU tensors run
    ``attention_small_plain``. Differentiable in q, k and v."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if mask is not None and (causal or lengths is not None):
        raise ValueError("pass EITHER an additive mask OR causal/lengths, not both")
    scale = float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionSmall.apply(q, k, v, mask, scale, bool(causal), lengths)
    return _forward(q, k, v, mask, scale, causal, lengths)


attention_small.launches = 0
