"""Blockwise (flash) attention: CUDA kernel, plain version and wrapper.

Port of ``clip_lora_match_tpu/ops/flash_attention.py``. q, k, v are
(B, S, H, d) in the projection layout, untransposed; d must be 64 for the
kernel. All arithmetic is at fp32 accuracy whatever the input dtype (the
kernel runs both products on the tensor cores as 3xTF32; P is never rounded),
with an optional additive fp32 mask broadcastable to (B, 1, S, S); the output
has q's dtype. The kernel is ``csrc/flash_attention.cu``.

It has no backward pass, as the JAX package's kernel has none: with grad
mode on and an input that requires grad, the wrapper raises instead of
returning a result cut off from the graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from clip_lora_match_tpu_torch.ops import _build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: q scaled in fp32, fp32
    scores plus the mask, fp32 softmax and P·V, cast to q's dtype."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def attention_reference(q, k, v, mask=None, scale=None) -> torch.Tensor:
    """Counterpart of the JAX package's ``attention_reference``, in its
    (B, H, S, d) layout: q scaled in its own dtype, fp32 scores and softmax,
    P·V accumulated in fp32, cast to q's dtype."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    if mask is not None:
        s = s + mask.float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _launch(q, k, v, mask, scale: float) -> torch.Tensor:
    B, S, H, hd = q.shape
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: float32 or bfloat16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError("flash_attention: q, k, v must share shape and device")
    # contiguous and 16-byte aligned (the kernel's cp.async rows): a view that
    # starts inside its storage is copied
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    mask_ptr, mask_bstride = None, 0
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32)
        if mask.dim() != 4:
            mask = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
        nb = 1 if mask.shape[0] == 1 else B
        mask = mask.expand(nb, 1, S, S).contiguous()
        mask_ptr, mask_bstride = mask.data_ptr(), (0 if nb == 1 else S * S)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    rc = lib.flash_attention_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(mask_ptr), ctypes.c_longlong(mask_bstride),
        ctypes.c_int(B), ctypes.c_int(S), ctypes.c_int(H), ctypes.c_int(hd),
        ctypes.c_float(scale), ctypes.c_int(_DTYPES[q.dtype]),
        ctypes.c_void_p(_build.stream_ptr(q)),
    )
    _build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, S, H, d) context. CUDA tensors launch the kernel; CPU tensors run
    ``flash_attention_plain``. Raises ``ValueError`` for a head_dim other
    than 64, and ``RuntimeError`` under autograd."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, S, H, d), got {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim must be {HEAD_DIM}, got {q.shape[-1]}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, mask)
    ):
        raise RuntimeError(
            "flash_attention has no backward pass: call it under torch.no_grad(), or "
            "differentiate with set_kernel_flags(flash_attention=False)"
        )
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, scale)
    return _launch(q, k, v, mask, float(scale))


flash_attention.launches = 0
