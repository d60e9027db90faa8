"""Bytes and operations of single kernels, from shapes: each input byte read
once, each output byte written once, whatever a kernel reads again. They are
the arithmetic of ``chip_smoke.py``'s ``bound_ms`` rows, copied here so that
the yardstick stays fixed. Nothing here imports the port."""

from __future__ import annotations

import math

from gpu_bench.harness.peaks import bound_s


def tilemax_sup(Q: int, N: int, D: int, elem: int = 4, tile: int = 16, group: int = 16) -> tuple[int, int]:
    """Pass 1 of the two-pass exact top-k with group maxima: the index and
    the queries read, the tile maxima and the group maxima written (fp32).
    → (bytes, operations)."""
    nt = math.ceil(N / tile)
    ng = math.ceil(nt / group)
    nbytes = N * D * elem + Q * D * elem + 4 * Q * (nt + ng)
    return nbytes, 2 * Q * N * D


def tilemax_sup_bound_s(Q: int, N: int, D: int) -> float:
    """The least time of pass 1 over an fp32 index."""
    return bound_s(*tilemax_sup(Q, N, D), "fp32")[0]


def lora_linear(M: int, K: int, N: int, r: int, groups: int = 1) -> tuple[int, int]:
    """``groups`` adapted projections of one input x (M, K) in bf16: x read
    once, each projection's W (K, N), A (K, r) and B (r, N) read and its
    output (M, N) written. → (bytes, operations)."""
    nbytes = (M * K + groups * (K * N + K * r + r * N + M * N)) * 2
    ops = groups * (2 * M * K * N + 2 * M * K * r + 2 * M * r * N)
    return nbytes, ops


def lora_tower_bound_s(M: int, width: int, layers: int, r: int) -> float:
    """The least time of a tower's adapted attention projections at M rows
    in bf16: per layer q/k/v over one read of their input, and out_proj."""
    qkv = bound_s(*lora_linear(M, width, width, r, groups=3), "bf16")[0]
    out = bound_s(*lora_linear(M, width, width, r), "bf16")[0]
    return layers * (qkv + out)
