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
``topk_retrieve_auto``. Otherwise a CUDA tensor launches the bin-max kernel
(``approx_topk.launches`` counts the launches) and then, for k <= ``K_MAX``,
the fused selection in the same source: the split maxima merged and the top
k of the bins selected in one or two launches
(``approx_topk.select_launches``), with no (Q, L) bins in memory and no sort.
Past ``K_MAX``, or with more bins than two selection launches hold, the
kernel's bins go through ``_select_bins`` (``approx_topk.sorts``). A CPU
tensor runs ``approx_topk_plain``; ``binmax_plain`` and ``select_plain`` are
the two launches' plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from clip_lora_match_tpu_torch.ops import _build
from clip_lora_match_tpu_torch.ops.retrieval_topk import (
    K_MAX,
    SMEM_BLOCK,
    _empty_if_k0,
    _normalize_div,
    topk_retrieve_auto,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# From this many queries on, the wgmma body (tensor cores, 16-64 queries a
# block); below it the CUDA-core body on blocks of 1-8 queries.
BINMAX_MMA_MIN_Q = 17
_BODIES = {"cuda_core": 0, "mma": 1}
_MAX_ROW_BYTES = 4096  # MAX_ROW_BYTES in the source
_SLICE = 128  # bytes of a row a wgmma ring stage (SLICE in the source)
_BOX = 64 * _SLICE  # a TMA box: 64 rows of one slice (BOX_BYTES)
_CORE_BINS = (16, 32, 64, 128)  # slabs of the CUDA-core body
_MMA_BINS = (64, 128)  # slabs of the wgmma body: one or two warpgroups of 64 rows
_MAX_STAGES = 8
_GRID_Z = 65_535  # query blocks (and splits) a launch takes
# the fused selection: one block takes SEL_CAP bins of a query (SEL_THREADS x
# SEL_EPT in the source); past it, chunks of _SEL_CHUNK and a second launch
SEL_CAP = 8192
_SEL_CHUNK = 4096


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


def _merge_splits(part_v: torch.Tensor, part_i: torch.Tensor):
    """(splits, Q, L) split maxima merged in split order: a later split's
    maximum replaces only a strictly smaller one (its rows are later)."""
    vals, ids = part_v[0], part_i[0]
    for s in range(1, part_v.shape[0]):
        take = part_v[s] > vals
        vals, ids = torch.where(take, part_v[s], vals), torch.where(take, part_i[s], ids)
    return vals, ids


def select_plain(part_v: torch.Tensor, part_i: torch.Tensor, k: int, chunk: int):
    """The fused selection's contract in plain PyTorch: the (splits, Q, L)
    split maxima merged in split order, then the top k of each chunk of
    ``chunk`` bins and the top k of those candidates (one chunk: the top k of
    the bins), descending, ties to the lower id. Equal to ``_select_bins``
    over the merged bins."""
    vals, ids = _merge_splits(part_v, part_i)
    if chunk >= vals.shape[1]:
        return _select_bins(vals, ids, k)
    cands = [_select_bins(vals[:, c:c + chunk], ids[:, c:c + chunk], min(k, vals.shape[1] - c))
             for c in range(0, vals.shape[1], chunk)]
    return _select_bins(torch.cat([c[0] for c in cands], 1), torch.cat([c[1] for c in cands], 1), k)


def select_plan(L: int, k: int) -> int | None:
    """The chunk of bins one block of the fused selection's first launch
    takes: L itself (one launch) up to ``SEL_CAP`` bins, else ``_SEL_CHUNK``
    or ``SEL_CAP`` with a second launch over the chunks' best k (at most
    ``SEL_CAP`` candidates). None where k is past ``K_MAX`` or L, or the
    candidates would overflow: those searches sort the kernel's bins
    (``_select_bins``)."""
    if not 1 <= k <= min(K_MAX, L):
        return None
    if L <= SEL_CAP:
        return L
    for chunk in (_SEL_CHUNK, SEL_CAP):
        if -(-L // chunk) * k <= SEL_CAP:
            return chunk
    return None


class BinmaxPlan(NamedTuple):
    """How one kernel call runs: the body, the query block, the bins of a
    block, the window splits, the grid (bin slabs, splits, query blocks), the
    rows of a CUDA-core ring stage (of a wgmma stage: its 128-byte K-slices),
    the ring's stages and the shared memory a block takes."""

    body: str
    qb: int
    bins: int
    splits: int
    grid: tuple
    rows: int
    stages: int
    smem: int


def _core_smem(qb: int, row_bytes: int, bins: int, rows: int, stages: int) -> int:
    """core_layout in the source: the ring, the staged queries, each (query,
    bin)'s best score and row, the barriers."""
    return stages * rows * row_bytes + -(-qb * row_bytes // 16) * 16 + 8 * qb * bins + 16 * stages


def _mma_smem(nq: int, row_bytes: int, terms: int, wg: int, sps: int, stages: int) -> int:
    """mma_smem in the source: alignment, the queries (``terms`` copies:
    TF32 hi and lo for fp32), the ring (stages of ``sps`` K-slices of ``wg``
    64-row boxes), the barriers."""
    return 1024 + terms * nq * row_bytes + stages * (wg * sps * _BOX + 16) + 16


def _mma_sps(row_bytes: int, wg: int) -> int:
    """K-slices a wgmma stage: 4 / warpgroups (32 KB), or 1 where a row's
    slices do not divide by it."""
    return 4 // wg if (row_bytes // _SLICE) % (4 // wg) == 0 else 1


def _mma_nq(Q: int, row_bytes: int, terms: int) -> int:
    """The wgmma body's query block: the next power of two from Q (16 to 64;
    fp32 to 32: its hi and lo queries are one N = 2 NQ product) that fits
    beside three 32 KB stages."""
    nq = min(64 // terms, max(16, 1 << (Q - 1).bit_length()))
    while nq > 16 and _mma_smem(nq, row_bytes, terms, 1, 4, 3) > SMEM_BLOCK:
        nq //= 2
    return nq


def _check_shape(Q: int, N: int, D: int, dtype, L: int) -> None:
    row_bytes = D * (4 if dtype == torch.float32 else 2)
    if row_bytes % 16 or row_bytes > _MAX_ROW_BYTES:
        raise ValueError(f"binmax kernel: rows of whole 16-byte vectors, at most {_MAX_ROW_BYTES} bytes, got "
                         f"D={D} ({row_bytes} bytes)")
    if L % 128 or not 128 <= L <= N:
        raise ValueError(f"binmax: L a multiple of 128 in [128, N], got L={L}, N={N}")


@functools.lru_cache(maxsize=256)  # a search's shape repeats: the plan is host time on every call
def binmax_plan(Q: int, N: int, D: int, dtype, L: int, sms: int) -> BinmaxPlan:
    """Q >= ``BINMAX_MMA_MIN_Q`` with rows of whole 128-byte slices takes
    the wgmma body on a query block of 16, 32 or 64 (``_mma_nq``; fp32's hi
    and lo queries fill shared memory at 32, or 16 from D = 768); every
    other shape the CUDA-core body on a block of 1, 2, 4 or 8 queries. One
    block an SM: the slab and the splits are the pair that streams the most
    even share of the index to each SM in the fewest waves, at most one
    split a window; the query blocks of a slab and split read the same
    windows side by side (the later read from L2). Raises where the kernel
    takes no such shape."""
    _check_shape(Q, N, D, dtype, L)
    row_bytes = D * (4 if dtype == torch.float32 else 2)
    terms = 2 if dtype == torch.float32 else 1
    W = -(-N // L)
    if Q >= BINMAX_MMA_MIN_Q and row_bytes % _SLICE == 0:
        body, qb = "mma", _mma_nq(Q, row_bytes, terms)
        # fp32 at 32 queries a block holds two sets of N = 64 and N = 32
        # accumulators: one warpgroup a block (two would spill registers)
        options = _MMA_BINS[:1] if terms == 2 and qb == 32 else _MMA_BINS
    else:
        body, qb = "cuda_core", 1 << (min(Q, 8) - 1).bit_length()
        options = _CORE_BINS
    qz = -(-Q // qb)
    if qz > _GRID_Z:
        raise ValueError(f"binmax kernel: at most {_GRID_Z} query blocks of {qb}, got Q={Q}")
    best = None
    for bins in options:
        slabs = L // bins
        for splits in sorted({1, W, *(min(W, max(1, m * sms // (slabs * qz))) for m in (1, 2, 3, 4))}):
            splits = min(splits, _GRID_Z)
            waves = -(-slabs * splits * qz // sms)
            # an SM's share of the index, plus the ramp of a block (~64 KB)
            # and the merge's read of a split
            cost = waves * (bins * -(-W // splits) * row_bytes + 65_536) + 1_536 * splits
            if best is None or (cost, slabs * splits) < best[0]:
                best = ((cost, slabs * splits), bins, splits)
    _, bins, splits = best
    if body == "mma":
        wg = bins // 64
        rows = _mma_sps(row_bytes, wg)  # K-slices a stage
        fixed = _mma_smem(qb, row_bytes, terms, wg, rows, 0)
        stages = min(_MAX_STAGES, (SMEM_BLOCK - fixed) // (wg * rows * _BOX + 16))
        smem = _mma_smem(qb, row_bytes, terms, wg, rows, stages)
    else:
        # ~32 KB a stage: R rows, a multiple of 16 (8 warps x 2 rows)
        rows = min(bins, 16 * _pow2_floor(max(1, 32_768 // (16 * row_bytes))))
        fixed = _core_smem(qb, row_bytes, bins, rows, 0)
        stages = min(_MAX_STAGES, (SMEM_BLOCK - fixed) // (rows * row_bytes + 16))
        smem = _core_smem(qb, row_bytes, bins, rows, stages)
    return BinmaxPlan(body, qb, bins, splits, (L // bins, splits, qz), rows, stages, smem)


def _pow2_floor(x: int) -> int:
    return 1 << (int(x).bit_length() - 1)


_P, _I = ctypes.c_void_p, ctypes.c_int
# binmax_fwd(queries, index, out_v, out_i, part_v, part_i, Q, N, D, L,
#            index_dtype, body, qb, bins, splits, rows, stages, stream)
_ARGTYPES = (_P,) * 6 + (_I,) * 11 + (_P,)
# select_fwd(part_v, part_i, out_v, out_i, cand_v, cand_i, Q, L, splits, k, chunk, stream)
_SELECT_ARGTYPES = (_P,) * 6 + (_I,) * 5 + (_P,)
# approx_fwd(queries, index, out_v, out_i, part_v, part_i, cand_v, cand_i, Q, N,
#            D, L, index_dtype, body, qb, bins, splits, rows, stages, k, chunk, stream)
_APPROX_ARGTYPES = (_P,) * 8 + (_I,) * 13 + (_P,)


def _check_args(qc: torch.Tensor, index: torch.Tensor, L: int) -> None:
    if qc.dim() != 2 or index.dim() != 2 or qc.shape[1] != index.shape[1]:
        raise ValueError(f"binmax: queries (Q, D) and index (N, D), got {tuple(qc.shape)} "
                         f"and {tuple(index.shape)}")
    if index.dtype not in _DTYPES or qc.dtype != index.dtype:
        raise TypeError(f"binmax: an fp32 or bf16 index and queries of its type, got "
                        f"{qc.dtype} and {index.dtype}")
    if qc.device != index.device:
        raise ValueError("binmax: queries and index on different devices")


def _plan(qc: torch.Tensor, index: torch.Tensor, L: int) -> BinmaxPlan:
    """The kernel's plan for this call (its refusals raise on either device)."""
    (Q, D), N = qc.shape, index.shape[0]
    sms = _build.sm_count(qc.device) if qc.device.type == "cuda" else 1
    return binmax_plan(Q, N, D, index.dtype, L, sms)


def _launch_args(qc: torch.Tensor, index: torch.Tensor, L: int, p: BinmaxPlan):
    """The 16-byte aligned queries and the split partials' scratch of one
    kernel call on the card."""
    if not index.is_contiguous() or index.data_ptr() % 16:
        raise ValueError("binmax kernel: a contiguous index with 16-byte aligned rows")
    qc = qc.contiguous()
    if qc.data_ptr() % 16:
        qc = qc.clone()
    part = torch.empty((2, p.splits * qc.shape[0] * L), dtype=torch.float32, device=qc.device)
    return qc, part[0], part[1].view(torch.int32)


def _plan_ints(p: BinmaxPlan) -> tuple:
    return _BODIES[p.body], p.qb, p.bins, p.splits, p.rows, p.stages


def _count(p: BinmaxPlan) -> None:
    approx_topk.launches += 1
    approx_topk.bodies[p.body] += 1


def binmax(qc: torch.Tensor, index: torch.Tensor, L: int):
    """(Q, L) bin maxima and row ids of ``qc·indexᵀ``, ``qc`` the normalized
    queries cast to the index type. CUDA tensors launch the kernel on the body
    ``binmax_plan`` picks (``approx_topk.launches`` counts the launches,
    ``approx_topk.bodies`` the body each took), then the merge of its splits;
    CPU tensors run ``binmax_plain``. Shapes the kernel does not take raise
    on either device."""
    _check_args(qc, index, L)
    p = _plan(qc, index, L)  # the kernel's refusals, before any launch
    if qc.device.type == "cpu":
        return binmax_plain(qc, index, L)
    (Q, D), N = qc.shape, index.shape[0]
    qc, part_v, part_i = _launch_args(qc, index, L, p)
    out_v = torch.empty((Q, L), dtype=torch.float32, device=qc.device)
    out_i = torch.empty((Q, L), dtype=torch.int32, device=qc.device)
    rc = _build.function("retrieval_binmax", "binmax_fwd", _ARGTYPES)(
        qc.data_ptr(), index.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), Q, N, D, L, _DTYPES[index.dtype], *_plan_ints(p), _build.stream_ptr(qc),
    )
    _build.check(rc, "binmax_fwd")
    _count(p)
    return out_v, out_i


def _select_buffers(Q: int, L: int, k: int, chunk: int, device):
    out_s = torch.empty((Q, k), dtype=torch.float32, device=device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=device)
    chunks = -(-L // chunk)
    cand = torch.empty((2, Q * chunks * min(k, chunk) if chunks > 1 else 0), dtype=torch.float32, device=device)
    return out_s, out_i, cand[0], cand[1].view(torch.int32), 1 + (chunks > 1)


def select_bins(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """The fused selection alone over given (Q, L) bins: the top k,
    descending, ties to the lower id, in one or two launches on a CUDA tensor
    (``approx_topk.select_launches`` counts them), ``select_plain`` on a CPU
    tensor. k <= ``K_MAX`` and k <= L."""
    Q, L = vals.shape
    chunk = select_plan(L, int(k))
    if chunk is None or ids.shape != vals.shape or vals.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"select_bins: (Q, L) fp32 maxima and int32 ids, 1 <= k <= min({K_MAX}, L) and at "
                         f"most {SEL_CAP} candidates, got {tuple(vals.shape)} {vals.dtype}, {tuple(ids.shape)} "
                         f"{ids.dtype}, k={k}")
    if vals.device.type == "cpu":
        return select_plain(vals[None], ids[None], k, chunk)
    vals, ids = vals.contiguous(), ids.contiguous()
    out_s, out_i, cand_v, cand_i, launches = _select_buffers(Q, L, k, chunk, vals.device)
    rc = _build.function("retrieval_binmax", "select_fwd", _SELECT_ARGTYPES)(
        vals.data_ptr(), ids.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), cand_v.data_ptr(),
        cand_i.data_ptr(), Q, L, 1, k, chunk, _build.stream_ptr(vals),
    )
    _build.check(rc, "select_fwd")
    approx_topk.select_launches += launches
    return out_s, out_i


def _approx_fused(qc: torch.Tensor, index: torch.Tensor, L: int, k: int, chunk: int):
    """The bin-max launch into its split partials, then the fused selection
    (merge, top k) in one or two launches: no (Q, L) bins, no sort."""
    p = _plan(qc, index, L)
    qc, part_v, part_i = _launch_args(qc, index, L, p)
    (Q, D), N = qc.shape, index.shape[0]
    out_s, out_i, cand_v, cand_i, launches = _select_buffers(Q, L, k, chunk, qc.device)
    rc = _build.function("retrieval_binmax", "approx_fwd", _APPROX_ARGTYPES)(
        qc.data_ptr(), index.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), Q, N, D, L, _DTYPES[index.dtype],
        *_plan_ints(p), k, chunk, _build.stream_ptr(qc),
    )
    _build.check(rc, "approx_fwd")
    _count(p)
    approx_topk.select_launches += launches
    return out_s, out_i


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
    ``k == 1`` or ``k > L``, the exact ``topk_retrieve_auto``. On the card,
    with k <= ``K_MAX`` and bins that ``select_plan`` takes, the bin-max
    launch and the fused selection (one or two launches); otherwise the
    kernel's bins through ``_select_bins`` (``approx_topk.sorts`` counts
    those searches). CPU tensors run the plain versions."""
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
    if index.device.type == "cpu":
        return _select_bins(*binmax_plain(qc, index, L), k)
    _check_args(qc, index, L)
    chunk = select_plan(L, k)
    if chunk is None:
        approx_topk.sorts += 1
        return _select_bins(*binmax(qc, index, L), k)
    return _approx_fused(qc, index, L, k, chunk)


approx_topk.launches = 0
approx_topk.bodies = dict.fromkeys(_BODIES, 0)
approx_topk.select_launches = 0  # launches of the fused selection
approx_topk.sorts = 0  # searches on the card whose selection sorted the bins (k > K_MAX, or too many bins)
