"""Fused transformer MLP ``y = quick_gelu(x @ W1 + b1) @ W2 + b2``: kernel,
plain version, wrapper.

Port of ``clip_lora_match_tpu/ops/mlp_fused.py``. x (M, K), W1 (K, H), W2 (H, N)
of x's dtype; b1 (H,), b2 (N,) are applied in fp32; both products accumulate
in fp32, bias and quick-gelu run in fp32 and the hidden is rounded to x's
dtype before fc2; the output has x's dtype. The kernel is
``csrc/mlp_fused.cu``; the (M, H) hidden never reaches device memory.

The wrapper is differentiable: under autograd it runs as ``_MlpFused``,
whose backward is the JAX package's ``custom_vjp`` backward
(``ops/mlp_fused.py:163-181``) in plain fp32 products: the hidden is
recomputed from x, quick-gelu's derivative taken as written there, and the
weight and bias gradients computed only where they are asked for (a frozen
base takes none).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from clip_lora_match_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
_BODIES = {"fp32": 0, "wmma": 1, "wgmma": 2}
# the wgmma body: rows of x per CTA, output columns per CTA, hidden units each
# CTA computes per step; the WMMA body: rows, columns, hidden units per chunk
_TM, _TN, _TS = 64, 256, 64
_BM, _BN, _BH = 64, 512, 64


class Plan(NamedTuple):
    """How one call runs: the kernel body, the CTAs of a cluster that share a
    row tile's fc1 (wgmma) or 1, the hidden units per step of a tile, and the
    blocks (clusters) that split each tile's hidden, added in order."""

    body: str
    cluster: int
    chunk: int
    splits: int


def takes_wgmma(K: int, H: int, N: int, aligned: bool) -> bool:
    """Whether the TMA/wgmma body takes the shape: x resident (K a multiple of
    64 up to 1024), 256-column CTA tiles in clusters of 2 to 4, 16-byte TMA
    strides and bases. Every CLIP MLP shape does (N = K in 512, 768, 1024)."""
    return (aligned and K % 64 == 0 and K <= 1024 and N % _TN == 0 and 2 * _TN <= N <= 4 * _TN
            and H % 8 == 0)


def plan(M: int, K: int, H: int, N: int, dtype, aligned: bool, sms: int) -> Plan:
    """The launch plan. bf16 tiles that are fewer than the SMs also split the
    hidden: enough splits to give each SM a block (one fits an SM), never more
    blocks than SMs, whole chunks each, every split non-empty."""
    if dtype == torch.float32:
        return Plan("fp32", 1, 32, 1)
    if takes_wgmma(K, H, N, aligned):
        cluster = N // _TN
        body, chunk, tiles = "wgmma", _TS * cluster, -(-M // _TM) * cluster
    else:
        body, cluster, chunk, tiles = "wmma", 1, _BH, -(-M // _BM) * -(-N // _BN)
    n_chunks = -(-H // chunk)
    splits = min(n_chunks, max(1, sms // tiles))
    per = -(-n_chunks // splits)
    return Plan(body, cluster, chunk, -(-n_chunks // per))


def _gelu_f32(h: torch.Tensor) -> torch.Tensor:
    return h * torch.sigmoid(1.702 * h)


def mlp_fused_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernel's contract in plain PyTorch (the JAX package's
    ``mlp_fused_reference``), every product in fp32."""
    h = x.float() @ w1.float() + b1.float()
    h = _gelu_f32(h).to(x.dtype)
    y = h.float() @ w2.float() + b2.float()
    return y.to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# mlp_fused_fwd(x, w1, b1, w2, b2, y, part, M, K, H, N, splits, body, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    M, K = x.shape
    H = w1.shape[1]
    N = w2.shape[1]
    if x.dtype not in _DTYPES or not (x.dtype == w1.dtype == w2.dtype):
        raise TypeError(
            f"mlp_fused: one dtype (float32 or bfloat16) for x, W1, W2; got "
            f"{x.dtype}, {w1.dtype}, {w2.dtype}"
        )
    if w1.shape != (K, H) or w2.shape != (H, N) or b1.shape != (H,) or b2.shape != (N,):
        raise ValueError(
            f"mlp_fused shapes: x {tuple(x.shape)} W1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
            f"W2 {tuple(w2.shape)} b2 {tuple(b2.shape)}"
        )
    if not all(t.device == x.device for t in (w1, b1, w2, b2)):
        raise ValueError("mlp_fused: x, W1, b1, W2, b2 must be on one device")
    x, w1, w2 = (t if t.is_contiguous() else t.contiguous() for t in (x, w1, w2))
    b1, b2 = (t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()
              for t in (b1, b2))
    aligned = (x.data_ptr() | w1.data_ptr() | w2.data_ptr()) % 16 == 0
    return _run(x, w1, b1, w2, b2, plan(M, K, H, N, x.dtype, aligned, _build.sm_count(x.device)))


def _run(x, w1, b1, w2, b2, p: Plan) -> torch.Tensor:
    """Launch the kernel under plan ``p`` (checked inputs; the C side refuses
    a plan the shape does not fit)."""
    M, K = x.shape
    H, N = w1.shape[1], w2.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # fp32 partial sums of the hidden splits, added by the kernel's second pass
    part = torch.empty((p.splits, M, N), dtype=torch.float32, device=x.device) if p.splits > 1 else None
    rc = _build.function("mlp_fused", "mlp_fused_fwd", _ARGTYPES)(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), M, K, H, N, p.splits, _BODIES[p.body],
        _build.stream_ptr(x),
    )
    _build.check(rc, "mlp_fused_fwd")
    mlp_fused.launches += 1
    return y


def mlp_fused_backward(x, w1, b1, w2, b2, g, need=(True,) * 5):
    """(dx, dW1, db1, dW2, db2) for the cotangent ``g``: the JAX package's
    backward in plain PyTorch, every product in fp32, the hidden and its
    gradient rounded to x's dtype as there; a gradient ``need`` leaves out is
    None."""
    x32, g32 = x.float(), g.float()
    hpre = x32 @ w1.float() + b1.float()
    sig = torch.sigmoid(1.702 * hpre)
    dgelu = sig * (1.0 + 1.702 * hpre * (1.0 - sig))
    dh = ((g32 @ w2.float().t()) * dgelu).to(x.dtype)
    dx = dw1 = db1 = dw2 = db2 = None
    if need[0]:
        dx = (dh.float() @ w1.float().t()).to(x.dtype)
    if need[1]:
        dw1 = (x32.t() @ dh.float()).to(w1.dtype)
    if need[2]:
        db1 = dh.float().sum(0).to(b1.dtype)
    if need[3]:
        h = (hpre * sig).to(x.dtype)
        dw2 = (h.float().t() @ g32).to(w2.dtype)
    if need[4]:
        db2 = g32.sum(0).to(b2.dtype)
    return dx, dw1, db1, dw2, db2


class _MlpFused(torch.autograd.Function):
    """The kernel (CUDA) or its plain version (CPU) forward; the JAX
    package's backward, the hidden recomputed."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return mlp_fused_backward(*ctx.saved_tensors, g, ctx.needs_input_grad)


def _forward(x, w1, b1, w2, b2) -> torch.Tensor:
    if x.device.type == "cpu":
        return mlp_fused_plain(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)


def mlp_fused(x, w1, b1, w2, b2) -> torch.Tensor:
    """(M, N) in x's dtype. CUDA tensors launch the kernel; CPU tensors run
    ``mlp_fused_plain``. Differentiable in every input."""
    if x.dim() != 2:
        raise ValueError(f"mlp_fused: x must be (M, K), got {tuple(x.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _MlpFused.apply(x, w1, b1, w2, b2)
    return _forward(x, w1, b1, w2, b2)


mlp_fused.launches = 0
