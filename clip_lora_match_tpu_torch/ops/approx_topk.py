"""Approximate top-k cosine retrieval: XLA's ApproxTopK binning, with the
partial reduce as a hand-written kernel (``csrc/retrieval_binmax.cu``).

The JAX package's ``top_k_similar(approximate=True)`` runs
``lax.approx_max_k(sims, k, recall_target)``, which on the TPU is XLA's
ApproxTopK op: the (Q, N) scores reduced into L bins, then an exact top-k
over the bins. This module keeps that contract:

- **The bin count.** ``reduction_bins`` is XLA's
  ``approx_top_k_reduction_output_size`` (``aggregate_to_topk=False``) for
  k >= 2; ``L == N`` means no reduction (the exact result).
- **The bins.** Row j falls into bin ``j mod L``: the scores, padded with
  -inf, viewed as (windows, L) and reduced over the windows. This is the
  TPU-KNN layout (Chern et al., 2022); the TPU's own bin assignment cannot
  be checked against a TPU here, and on the CPU JAX's ``approx_max_k`` is
  exact.
- **Ties.** Inside a bin the maximum's id is the lowest row among equal
  scores; the exact top-k over the L maxima breaks ties toward the lower id,
  as the exact path does.
- **Query precision.** The normalized query is cast to the index dtype and
  the product accumulates in fp32, as in the JAX package.

``approx_topk`` takes ``L == N``, ``k == 1`` (a maximum of bin maxima is
exact) and ``k > L`` (a recall target far below any in use) to
``topk_retrieve_auto``. Otherwise a CUDA tensor launches the
kernel (``approx_topk.launches`` counts the launches) and a CPU tensor runs
``approx_topk_plain``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from clip_lora_match_tpu_torch.ops import _build
from clip_lora_match_tpu_torch.ops.retrieval_topk import (
    SMEM_BLOCK,
    _empty_if_k0,
    _normalize_div,
    topk_retrieve_auto,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# From this many queries on, the mma body (tensor cores, 32 or 64 queries
# staged once); below it the CUDA-core body on blocks of 1-8 queries.
BINMAX_MMA_MIN_Q = 17
_BODIES = {"cuda_core": 0, "mma": 1}
_CORE_BINS, _MMA_BINS = 64, 128  # bins of a block (CORE_BINS, MMA_BINS in the source)
_CHUNK = 64  # bytes of a row per mma k-chunk


def reduction_bins(N: int, k: int, recall_target: float) -> tuple[int, int]:
    """(L, lg): the bins XLA's ApproxTopK reduces N scores into for the
    top ``k`` at ``recall_target``, and log2 of the rows folded into a bin;
    ``(N, 0)`` where there is no reduction (``recall_target >= 1``, N <= 128,
    a target that needs no reduction, and k <= 1, where the port takes the
    exact route)."""
    N, k = int(N), int(k)
    if not recall_target > 0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    if k <= 1 or recall_target >= 1 or N <= 128:
        return N, 0
    m = min(max(int((1 - k) / math.log(recall_target)), 128), N)
    lg = (N // m).bit_length() - 1  # floor(log2(N // m))
    if lg <= 0:
        return N, 0
    lg = min(lg, (-(-N // m) - 1).bit_length())  # ceil(log2(ceil(N / m)))
    return -(-(-(-N // 128)) // (1 << lg)) * 128, lg


def binmax_plain(qc: torch.Tensor, index: torch.Tensor, L: int):
    """The kernel's contract in plain PyTorch: (Q, L) fp32 bin maxima of
    ``qc·indexᵀ`` (row j in bin j mod L) and their int32 row ids, the lowest
    row among equal scores."""
    Q, N = qc.shape[0], index.shape[0]
    W = -(-N // L)
    sims = qc.float() @ index.float().T
    if W * L != N:
        sims = torch.nn.functional.pad(sims, (0, W * L - N), value=-float("inf"))
    vals, win = torch.max(sims.view(Q, W, L), dim=1)  # the first (lowest) window of a tie
    ids = win * L + torch.arange(L, device=qc.device)
    return vals, ids.to(torch.int32)


def _select_bins(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Exact top-k over the bin maxima, descending, ties to the lower id."""
    by_id = torch.argsort(ids, dim=1)
    vals, ids = vals.gather(1, by_id), ids.gather(1, by_id)
    s, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), ids.gather(1, pos[:, :k]).contiguous()


class BinmaxPlan(NamedTuple):
    """How one kernel call runs: the body, the query block, the bins of a
    block, the window splits and the grid (bin slabs, splits, query
    blocks)."""

    body: str
    qb: int
    bins: int
    splits: int
    grid: tuple


def _mma_smem(qb: int, row_bytes: int) -> int:
    return qb * ((row_bytes + 127) // 128 * 128 + 64)


def binmax_plan(Q: int, N: int, D: int, dtype, L: int, sms: int) -> BinmaxPlan:
    """Q >= ``BINMAX_MMA_MIN_Q`` with rows of whole 64-byte k-chunks takes
    the mma body on a query block of 32 (Q <= 32) or 64 queries (one block an
    SM); every other shape the CUDA-core body on a block of 1, 2, 4 or 8
    queries (two blocks an SM). The windows are split so that the grid fills
    the card once, at most one split a window."""
    row_bytes = D * (4 if dtype == torch.float32 else 2)
    W = -(-N // L)
    qb = 32 if Q <= 32 else 64
    if Q >= BINMAX_MMA_MIN_Q and row_bytes % _CHUNK == 0 and _mma_smem(qb, row_bytes) <= SMEM_BLOCK:
        body, bins, per_sm = "mma", _MMA_BINS, 1
    else:
        body, qb, bins, per_sm = "cuda_core", 1 << (min(Q, 8) - 1).bit_length(), _CORE_BINS, 2
    gx, gz = L // bins, -(-Q // qb)
    splits = max(1, min(W, -(-per_sm * sms // (gx * gz)), 65535))
    return BinmaxPlan(body, qb, bins, splits, (gx, splits, gz))


_P, _I = ctypes.c_void_p, ctypes.c_int
# binmax_fwd(queries, index, out_v, out_i, part_v, part_i, Q, N, D, L,
#            index_dtype, body, qb, splits, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)


def binmax(qc: torch.Tensor, index: torch.Tensor, L: int):
    """(Q, L) bin maxima and row ids of ``qc·indexᵀ``, ``qc`` the normalized
    queries cast to the index type. CUDA tensors launch the kernel on the body
    ``binmax_plan`` picks (``approx_topk.launches`` counts the launches,
    ``approx_topk.bodies`` the body each took); CPU tensors run
    ``binmax_plain``."""
    if qc.dim() != 2 or index.dim() != 2 or qc.shape[1] != index.shape[1]:
        raise ValueError(f"binmax: queries (Q, D) and index (N, D), got {tuple(qc.shape)} "
                         f"and {tuple(index.shape)}")
    if index.dtype not in _DTYPES or qc.dtype != index.dtype:
        raise TypeError(f"binmax: an fp32 or bf16 index and queries of its type, got "
                        f"{qc.dtype} and {index.dtype}")
    (Q, D), N = qc.shape, index.shape[0]
    if L % 128 or not 128 <= L <= N:
        raise ValueError(f"binmax: L a multiple of 128 in [128, N], got L={L}, N={N}")
    if qc.device != index.device:
        raise ValueError("binmax: queries and index on different devices")
    if qc.device.type == "cpu":
        return binmax_plain(qc, index, L)
    if not index.is_contiguous() or (D * index.element_size()) % 16 or index.data_ptr() % 16:
        raise ValueError("binmax kernel: a contiguous index with 16-byte aligned rows")
    qc = qc.contiguous()
    if qc.data_ptr() % 16:
        qc = qc.clone()
    p = binmax_plan(Q, N, D, index.dtype, L, _build.sm_count(qc.device))
    dev = qc.device
    out_v = torch.empty((Q, L), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, L), dtype=torch.int32, device=dev)
    part = (Q * L * p.splits) if p.splits > 1 else 0
    part_v = torch.empty(part, dtype=torch.float32, device=dev)
    part_i = torch.empty(part, dtype=torch.int32, device=dev)
    rc = _build.function("retrieval_binmax", "binmax_fwd", _ARGTYPES)(
        qc.data_ptr(), index.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), Q, N, D, L, _DTYPES[index.dtype],
        _BODIES[p.body], p.qb, p.splits, _build.stream_ptr(qc),
    )
    _build.check(rc, "binmax_fwd")
    approx_topk.launches += 1
    approx_topk.bodies[p.body] += 1
    return out_v, out_i


def approx_topk_plain(queries: torch.Tensor, index: torch.Tensor, k: int = 5,
                      recall_target: float = 0.95):
    """The binned selection in plain PyTorch: the product (``torch.matmul``),
    the bin maxima, the exact top-k over the bins."""
    k = min(int(k), index.shape[0])
    L, _ = reduction_bins(index.shape[0], k, recall_target)
    qc = _normalize_div(queries).to(index.dtype)
    return _select_bins(*binmax_plain(qc, index, L), k)


def approx_topk(queries: torch.Tensor, index: torch.Tensor, k: int = 5,
                recall_target: float = 0.95):
    """Approximate top-k cosine retrieval of raw (Q, D) queries over a
    normalized fp32 or bf16 index: (scores (Q, k) fp32 descending, ids (Q, k)
    int32), ``k`` clamped to N. Where there is no reduction (``L == N``),
    ``k == 1`` or ``k > L``, the exact ``topk_retrieve_auto``."""
    if queries.dim() != 2 or index.dim() != 2:
        raise ValueError("approx_topk: queries (Q, D) and index (N, D)")
    empty = _empty_if_k0(queries, k)
    if empty is not None:
        return empty
    N = index.shape[0]
    k = min(int(k), N)
    L, _ = reduction_bins(N, k, recall_target)
    if L == N or k > L:
        return topk_retrieve_auto(queries, index, k)
    qc = _normalize_div(queries).to(index.dtype)
    return _select_bins(*binmax(qc, index, L), k)


approx_topk.launches = 0
approx_topk.bodies = dict.fromkeys(_BODIES, 0)
