"""Fused LoRA matmul ``y = x @ W + s·round(x @ A) @ B``: kernel, plain, wrapper.

Port of ``clip_lora_match_tpu/ops/lora_matmul.py``. x (M, K), W (K, N),
A (K, r), B (r, N), all of x's dtype; fp32 accumulation; the rank-r partial
is rounded to x's dtype before B is applied; the output has x's dtype. The
kernel is ``csrc/lora_matmul.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from clip_lora_match_tpu_torch.ops import _build

R_MAX = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lora_matmul_plain(x, w, a, b, scaling: float = 1.0) -> torch.Tensor:
    """The kernel's contract in plain PyTorch, every product in fp32."""
    base = x.float() @ w.float()
    xa = (x.float() @ a.float()).to(x.dtype)
    delta = xa.float() @ b.float()
    return (base + scaling * delta).to(x.dtype)


def _launch(x, w, a, b, scaling: float) -> torch.Tensor:
    M, K = x.shape
    N = w.shape[1]
    r = a.shape[1]
    if x.dtype not in _DTYPES or not (x.dtype == w.dtype == a.dtype == b.dtype):
        raise TypeError(
            f"lora_matmul: one dtype (float32 or bfloat16) for x, W, A, B; got "
            f"{x.dtype}, {w.dtype}, {a.dtype}, {b.dtype}"
        )
    if w.shape != (K, N) or a.shape != (K, r) or b.shape != (r, N):
        raise ValueError(
            f"lora_matmul shapes: x {tuple(x.shape)} W {tuple(w.shape)} "
            f"A {tuple(a.shape)} B {tuple(b.shape)}"
        )
    if not 1 <= r <= R_MAX:
        raise ValueError(f"lora_matmul kernel: 1 <= r <= {R_MAX}, got {r}")
    if not all(t.device == x.device for t in (w, a, b)):
        raise ValueError("lora_matmul: x, W, A, B must be on one device")
    x, w, a, b = x.contiguous(), w.contiguous(), a.contiguous(), b.contiguous()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.load("lora_matmul")
    rc = lib.lora_matmul_fwd(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), ctypes.c_int(M), ctypes.c_int(N),
        ctypes.c_int(K), ctypes.c_int(r), ctypes.c_float(scaling),
        ctypes.c_int(_DTYPES[x.dtype]), ctypes.c_void_p(_build.stream_ptr(x)),
    )
    _build.check(rc, "lora_matmul_fwd")
    lora_matmul.launches += 1
    return y


def lora_matmul(x, w, a, b, scaling: float = 1.0) -> torch.Tensor:
    """(M, N) in x's dtype. CUDA tensors launch the kernel; CPU tensors run
    ``lora_matmul_plain``."""
    if x.dim() != 2:
        raise ValueError(f"lora_matmul: x must be (M, K), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lora_matmul_plain(x, w, a, b, scaling)
    return _launch(x, w, a, b, float(scaling))


lora_matmul.launches = 0
