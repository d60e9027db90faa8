"""Fused LoRA matmul ``y = x @ W + s·round(x @ A) @ B``: kernel, plain, wrapper.

Port of ``clip_lora_match_tpu/ops/lora_matmul.py``. x (M, K), W (K, N),
A (K, r), B (r, N), all of x's dtype; fp32 accumulation; the rank-r partial
is rounded to x's dtype before B is applied; the output has x's dtype. With
``groups`` G the (M, N) product comes back as (G, M, N / G): column n lands
in slab n // (N / G), which is how the q, k and v projections of one
attention layer run as one launch (``nn.layers.group_qkv``). The kernel is
``csrc/lora_matmul.cu``; it reads A through its transpose A^T (r, K), so an
A that is the transposed view of a contiguous (r, K) tensor (the serving
copy's layout) is passed without a copy.

The wrapper is differentiable: under autograd it runs as ``_LoraMatmul``,
whose backward is the JAX package's ``custom_vjp`` backward
(``ops/lora_matmul.py:125-143``) as plain products with fp32 accumulation:
dx, dA and dB always, dW only where W requires grad (a frozen base takes
none). There is no backward kernel: the JAX package's backward is plain XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from clip_lora_match_tpu_torch.ops import _build

R_MAX = 64
_DTYPES = (torch.float32, torch.bfloat16)
_BODIES = {"fp32": 0, "wmma": 1, "wgmma": 2}
# wgmma tiles (rows, columns), largest first
_TILES = ((128, 128), (64, 128), (64, 64))


class Plan(NamedTuple):
    """How one call runs: the kernel body and its output tile (rows, columns)."""

    body: str
    bm: int
    bn: int


def takes_wgmma(K: int, N: int, groups: int, aligned: bool) -> bool:
    """Whether the TMA/wgmma body takes the shape: 16-byte TMA strides and
    bases (K and N / groups multiples of 8). Every CLIP projection does."""
    return aligned and K % 8 == 0 and N % groups == 0 and (N // groups) % 8 == 0


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, r: int, dtype, aligned: bool, sms: int, groups: int = 1) -> Plan:
    """The launch plan. bf16 through wgmma takes the largest tile whose grid
    reaches about the SMs (7/8 of them: one L/14-336 image's grouped q/k/v,
    120 128 x 128 tiles, ran faster than 240 64 x 128 ones), else the
    smallest tile, whose grid is the largest. K is not split: at request
    rows a split saved under 0.4 us a call on the card and cost a second
    launch. Shapes TMA cannot take run the WMMA body, fp32 the CUDA-core
    one. Cached: a tower asks for the same few shapes."""
    if dtype == torch.float32:
        return Plan("fp32", 64, 64)
    if not takes_wgmma(K, N, groups, aligned):
        return Plan("wmma", 64, 64)
    for bm, bn in _TILES:
        if 8 * -(-M // bm) * -(-N // bn) >= 7 * sms:
            return Plan("wgmma", bm, bn)
    return Plan("wgmma", *_TILES[-1])


def lora_matmul_plain(x, w, a, b, scaling: float = 1.0, groups: int = 1) -> torch.Tensor:
    """The kernel's contract in plain PyTorch, every product in fp32."""
    base = x.float() @ w.float()
    xa = (x.float() @ a.float()).to(x.dtype)
    delta = xa.float() @ b.float()
    y = (base + scaling * delta).to(x.dtype)
    if groups == 1:
        return y
    M, N = y.shape
    return y.view(M, groups, N // groups).transpose(0, 1).contiguous()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# lora_matmul_fwd(x, w, at, b, y, M, N, K, r, groups, scaling, body, bm, bn, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P)


def _launch(x, w, a, b, scaling: float, groups: int) -> torch.Tensor:
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
    if groups < 1 or N % groups:
        raise ValueError(f"lora_matmul: {groups} groups do not divide N = {N}")
    if not all(t.device == x.device for t in (w, a, b)):
        raise ValueError("lora_matmul: x, W, A, B must be on one device")
    x, w, b, at = x.contiguous(), w.contiguous(), b.contiguous(), a.t().contiguous()
    aligned = (x.data_ptr() | w.data_ptr() | at.data_ptr() | b.data_ptr()) % 16 == 0
    p = plan(M, N, K, r, x.dtype, aligned, _build.sm_count(x.device), groups)
    return _run(x, w, at, b, scaling, groups, p)


def _run(x, w, at, b, scaling: float, groups: int, p: Plan) -> torch.Tensor:
    """Launch the kernel under plan ``p`` on checked, dense inputs (A passed
    as A^T); the C side refuses a plan the shape does not fit."""
    M, K = x.shape
    N, r = w.shape[1], at.shape[0]
    y = torch.empty((groups, M, N // groups), dtype=x.dtype, device=x.device)
    rc = _build.function("lora_matmul", "lora_matmul_fwd", _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), at.data_ptr(), b.data_ptr(), y.data_ptr(),
        M, N, K, r, groups, scaling, _BODIES[p.body], p.bm, p.bn, _build.stream_ptr(x),
    )
    _build.check(rc, "lora_matmul_fwd")
    lora_matmul.launches += 1
    return y[0] if groups == 1 else y


def lora_matmul_backward(x, w, a, b, g, scaling: float, groups: int = 1, need=(True,) * 4):
    """(dx, dW, dA, dB) for the cotangent ``g`` of ``lora_matmul``'s output:
    the JAX package's backward in plain PyTorch, every product in fp32, the
    rank-r partials rounded to x's dtype as there; a gradient ``need`` leaves
    out is None. Under ``groups`` the (G, M, N / G) cotangent is laid back
    out as (M, N): with blockdiag(B) the A and B blocks of each group get
    what that group's own launch would, and the zero blocks' gradient reaches
    no adapter."""
    M, K = x.shape
    N = w.shape[1]
    g32 = (g.transpose(0, 1).reshape(M, N) if groups > 1 else g).float()
    x32 = x.float()
    gb = (g32 @ b.float().t()).to(x.dtype)  # (M, r)
    dx = dw = da = db = None
    if need[0]:
        dx = (g32 @ w.float().t() + scaling * (gb.float() @ a.float().t())).to(x.dtype)
    if need[1]:
        dw = (x32.t() @ g32).to(w.dtype)
    if need[2]:
        da = (scaling * (x32.t() @ gb.float())).to(a.dtype)
    if need[3]:
        xa = (x32 @ a.float()).to(x.dtype)  # (M, r)
        db = (scaling * (xa.float().t() @ g32)).to(b.dtype)
    return dx, dw, da, db


class _LoraMatmul(torch.autograd.Function):
    """The kernel (CUDA) or its plain version (CPU) forward; the JAX
    package's backward, recomputed from the inputs."""

    @staticmethod
    def forward(ctx, x, w, a, b, scaling, groups):
        ctx.save_for_backward(x, w, a, b)
        ctx.scaling, ctx.groups = scaling, groups
        return _forward(x, w, a, b, scaling, groups)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        grads = lora_matmul_backward(x, w, a, b, g, ctx.scaling, ctx.groups, ctx.needs_input_grad[:4])
        return (*grads, None, None)


def _forward(x, w, a, b, scaling: float, groups: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return lora_matmul_plain(x, w, a, b, scaling, groups)
    return _launch(x, w, a, b, scaling, groups)


def lora_matmul(x, w, a, b, scaling: float = 1.0, groups: int = 1) -> torch.Tensor:
    """(M, N) in x's dtype, or (groups, M, N / groups). CUDA tensors launch
    the kernel; CPU tensors run ``lora_matmul_plain``. Differentiable in x,
    W, A and B."""
    if x.dim() != 2:
        raise ValueError(f"lora_matmul: x must be (M, K), got {tuple(x.shape)}")
    scaling, groups = float(scaling), int(groups)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, a, b)):
        return _LoraMatmul.apply(x, w, a, b, scaling, groups)
    return _forward(x, w, a, b, scaling, groups)


lora_matmul.launches = 0
