"""Fused transformer MLP ``y = quick_gelu(x @ W1 + b1) @ W2 + b2``: kernel,
plain version, wrapper.

Port of ``clip_lora_match_tpu/ops/mlp_fused.py`` (forward only; its
``custom_vjp`` backward comes with training). x (M, K), W1 (K, H), W2 (H, N)
of x's dtype; b1 (H,), b2 (N,) are applied in fp32; both products accumulate
in fp32, bias and quick-gelu run in fp32 and the hidden is rounded to x's
dtype before fc2; the output has x's dtype. The kernel is
``csrc/mlp_fused.cu``; the (M, H) hidden never reaches device memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from clip_lora_match_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel's tile: rows of x, columns of y, hidden units per chunk
_BM, _BN, _BH = 64, 512, 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _hidden_splits(M: int, N: int, H: int, sms: int) -> int:
    """How many blocks share each (row, column) tile's hidden in the bf16
    kernel: enough to give each SM a block (one fits an SM) when the tiles
    alone do not, never more blocks than SMs, whole 64-unit chunks each."""
    tiles = -(-M // _BM) * -(-N // _BN)
    n_chunks = -(-H // _BH)
    splits = min(n_chunks, max(1, sms // tiles))
    per = -(-n_chunks // splits)
    return -(-n_chunks // per)


def _gelu_f32(h: torch.Tensor) -> torch.Tensor:
    return h * torch.sigmoid(1.702 * h)


def mlp_fused_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernel's contract in plain PyTorch (the JAX package's
    ``mlp_fused_reference``), every product in fp32."""
    h = x.float() @ w1.float() + b1.float()
    h = _gelu_f32(h).to(x.dtype)
    y = h.float() @ w2.float() + b2.float()
    return y.to(x.dtype)


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
    x, w1, w2 = x.contiguous(), w1.contiguous(), w2.contiguous()
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    splits = 1
    if x.dtype == torch.bfloat16:
        splits = _hidden_splits(M, N, H, _sm_count(x.device.index or 0))
    # fp32 partial sums of the hidden splits, added by the kernel's second pass
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _build.load("mlp_fused")
    rc = lib.mlp_fused_fwd(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w1.data_ptr()),
        ctypes.c_void_p(b1.data_ptr()), ctypes.c_void_p(w2.data_ptr()),
        ctypes.c_void_p(b2.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        ctypes.c_void_p(None if part is None else part.data_ptr()),
        ctypes.c_int(M), ctypes.c_int(K), ctypes.c_int(H), ctypes.c_int(N),
        ctypes.c_int(splits), ctypes.c_int(_DTYPES[x.dtype]),
        ctypes.c_void_p(_build.stream_ptr(x)),
    )
    _build.check(rc, "mlp_fused_fwd")
    mlp_fused.launches += 1
    return y


def mlp_fused(x, w1, b1, w2, b2) -> torch.Tensor:
    """(M, N) in x's dtype. CUDA tensors launch the kernel; CPU tensors run
    ``mlp_fused_plain``."""
    if x.dim() != 2:
        raise ValueError(f"mlp_fused: x must be (M, K), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return mlp_fused_plain(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)


mlp_fused.launches = 0
