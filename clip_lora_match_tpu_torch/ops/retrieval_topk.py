"""Exact top-k cosine retrieval: kernels, plain versions, wrappers, bands.

Port of ``clip_lora_match_tpu/ops/retrieval_topk.py``. ``topk_retrieve``
(streaming band, ``csrc/retrieval_topk.cu``) normalizes the raw queries
(``q·rsqrt(Σq²+1e-12)``), scores them against an L2-normalized fp32 or bf16
index in fp32, and returns (scores (Q, k) fp32 descending, ids (Q, k) int32),
ties to the lower row id. At HBM scale ``topk_retrieve_twopass`` and
``topk_retrieve_q8`` (int8 index) run pass 1 as tile maxima
(``csrc/retrieval_tilemax.cu``: ``tilemax``, ``tilemax_sup``,
``tilemax_sup_q8``, each on the body ``tilemax_plan`` picks), then passes 2
and 3 in PyTorch. ``topk_retrieve_auto`` keeps the JAX package's size bands.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from clip_lora_match_tpu_torch.ops import _build

K_MAX = 256
D_MAX = 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Band edges of the JAX package's dispatch (ops/retrieval_topk.py there).
TWOPASS_MIN_N = 65_536
MIDSCALE_MIN_N = 32_768

NEG_INF = float(torch.finfo(torch.float32).min)
# Hierarchical pass 2 (group maxima first) from this many main-part tiles on,
# and from Q8_HIER_MIN_TILES on the int8 index: the JAX package's gates, kept
# so that both packages take the same route.
HIER_GROUP = 16
HIER_MIN_TILES = 61_440
Q8_HIER_MIN_TILES = 16_384
# Cap on the int8 path's (Q, nt) tile-maxima transient; above it passes 1+2
# run in query chunks of a multiple of _Q8_MIN_CHUNK.
_Q8_MAXIMA_BYTES = 4 << 30
_Q8_MIN_CHUNK = 512
# the JAX package's MXU operand types; both give the same integers
_Q8_MXU = ("int8", "bf16")


def _normalize(queries: torch.Tensor) -> torch.Tensor:
    q = queries.float()
    return q * torch.rsqrt((q * q).sum(1, keepdim=True) + 1e-12)


def _normalize_div(queries: torch.Tensor) -> torch.Tensor:
    """The oracle's and the mid band's form: q / max(|q|, 1e-12)."""
    q = queries.float()
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-12)


def _sorted_topk(sims: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of each row, descending, ties to the lower column."""
    s, i = torch.sort(sims, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def _empty_if_k0(queries: torch.Tensor, k: int):
    """The entry points' ``k`` contract (``lax.top_k``'s in the JAX package):
    ``k < 0`` raises; ``k == 0`` gives the empty (Q, 0) result, returned here
    (None otherwise)."""
    if k < 0:
        raise ValueError(f"top-k: k must be nonnegative, got {k}")
    if k > 0:
        return None
    Q = queries.shape[0]
    return (torch.empty((Q, 0), dtype=torch.float32, device=queries.device),
            torch.empty((Q, 0), dtype=torch.int32, device=queries.device))


def topk_retrieve_plain(queries, index, k: int = 5):
    """The kernel's contract in plain PyTorch."""
    k = min(k, index.shape[0])
    sims = _normalize(queries) @ index.float().T
    return _sorted_topk(sims, k)


# -- the streaming kernel's launch plan (csrc/retrieval_topk.cu) ----------------

SMEM_BLOCK = 232_448  # dynamic shared memory one block may take (H100)
SMEM_SM = 233_472  # shared memory of one SM
_STAGE_BYTES = 16_384  # rows body: bytes of index rows per bulk copy
_RING = 4  # rows body: bulk-copy stages
_TILE_QT, _TILE_KS, _TILE_RT, _TILE_STAGES = 64, 32, 64, 4  # tile body
_BODIES = {"rows": 0, "plain": 1, "tile": 2}


class Plan(NamedTuple):
    """How one call runs: the pass-1 body (``rows``: whole rows through a
    bulk-copy ring; ``tile``: 8 queries a warp against 64-row steps
    through a cp.async ring; ``plain``: scalar loads, for an unaligned
    index), the query tile of a block, the rows per stage (rows, plain) or
    per step (tile), the ring's stages, each block's contiguous row range,
    the grid (row blocks, query tiles) and the shared memory of a pass-1
    block."""

    body: str
    qt: int
    rows: int
    stages: int
    rows_per_block: int
    grid: tuple
    smem: int


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _rows_smem(qt, D, k, R, S, elem, bulk) -> int:
    """Shared memory of the rows and plain bodies (``rows_layout`` in the
    source): the ring, the normalized query tile, two score buffers, the
    k-lists' scratch, the ring's barriers."""
    qs = _up(S * R * D * elem, 128) if bulk else 0
    sc = _up(qs + qt * D * 4, 16)
    return _up(sc + 2 * qt * R * 4 + 2 * qt * k * 4, 8) + (8 * S if bulk else 0)


def _tile_smem(k, elem) -> int:
    """Shared memory of the tile body (``tile_smem`` in the source): 1/|q| of
    the tile's queries, their k-lists, then the ring of (query slice, index
    slice)."""
    return _up(_TILE_QT * 4, 16) + _TILE_QT * k * 8 + _TILE_STAGES * (
        _TILE_QT * (_TILE_KS + 4) * 4 + _TILE_RT * (_TILE_KS * elem + 16))


def plan(Q: int, N: int, D: int, k: int, dtype, aligned: bool, sms: int) -> Plan:
    """The launch plan. ``aligned``: the index's base is 16-byte aligned
    (its row pitch is checked here). Q > 8 takes the tile body (64 queries
    a block); Q <= 8 the rows body on a query tile of 1, 2, 4 or 8 (the
    next power of two at or above Q); an index a 16-byte copy cannot take,
    the plain body on tiles of 8 queries. The grid holds as many row blocks as fit on the
    card at once (at most 2 per SM), divided among the query tiles, each
    block an equal contiguous range of rows."""
    elem = 4 if dtype == torch.float32 else 2
    bulk = aligned and (D * elem) % 16 == 0
    if Q > 8 and bulk:
        return _grid("tile", _TILE_QT, _TILE_RT, _TILE_STAGES, _tile_smem(k, elem), Q, N, sms)
    qt = 1 << (Q - 1).bit_length() if Q <= 8 and bulk else 8
    R = max(1, min(32, _STAGE_BYTES // (D * elem)))
    S = _RING if bulk else 0  # at most 128 KB of queries + 64 KB of ring + 16 KB of lists
    return _grid("rows" if bulk else "plain", qt, R, S, _rows_smem(qt, D, k, R, S, elem, bulk),
                 Q, N, sms)


def _grid(body, qt, unit, S, smem, Q, N, sms) -> Plan:
    per_sm = max(1, min(2, SMEM_SM // (smem + 1024)))
    gy = -(-Q // qt)
    want = -(-per_sm * sms // gy)
    rpb = max(unit, -(-N // want))
    return Plan(body, qt, unit, S, rpb, (-(-N // rpb), gy), smem)


_P, _I = ctypes.c_void_p, ctypes.c_int
# topk_retrieve_fwd(queries, index, cand_s, cand_i, out_s, out_i, Q, N, D, k,
#                   index_dtype, body, qt, rows, stages, rows_per_block, grid_x, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)


def _launch(queries, index, k: int):
    Q, D = queries.shape
    N = index.shape[0]
    if index.dtype not in _DTYPES:
        raise TypeError(f"topk_retrieve: float32 or bfloat16 index, got {index.dtype}")
    if index.shape[1] != D or index.device != queries.device:
        raise ValueError(
            f"topk_retrieve: queries {tuple(queries.shape)} and index "
            f"{tuple(index.shape)} must share D and device"
        )
    if k > K_MAX:
        raise ValueError(f"topk_retrieve kernel: k <= {K_MAX}, got {k}")
    if D > D_MAX:
        raise ValueError(f"topk_retrieve kernel: D <= {D_MAX}, got {D}")
    q = queries.float().contiguous()
    if q.data_ptr() % 16:  # the tile body copies query rows in 16-byte chunks
        q = q.clone()
    index = index.contiguous()
    p = plan(Q, N, D, k, index.dtype, index.data_ptr() % 16 == 0, _build.sm_count(q.device))
    dev = q.device
    cand_s = torch.empty((Q, p.grid[0], k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((Q, p.grid[0], k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    rc = _build.function("retrieval_topk", "topk_retrieve_fwd", _ARGTYPES)(
        q.data_ptr(), index.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), Q, N, D, k, _DTYPES[index.dtype],
        _BODIES[p.body], p.qt, p.rows, p.stages, p.rows_per_block, p.grid[0],
        _build.stream_ptr(q),
    )
    _build.check(rc, "topk_retrieve_fwd")
    topk_retrieve.launches += 1
    topk_retrieve.bodies[p.body] += 1
    return out_s, out_i


def topk_retrieve(queries: torch.Tensor, index: torch.Tensor, k: int = 5):
    """Fused top-k cosine retrieval (k clamped to N). CUDA tensors launch the
    kernel (``launches`` counts the calls, ``bodies`` the pass-1 body each
    took); CPU tensors run ``topk_retrieve_plain``."""
    if queries.dim() != 2 or index.dim() != 2:
        raise ValueError("topk_retrieve: queries (Q, D) and index (N, D)")
    k = min(int(k), index.shape[0])
    if k < 1:
        raise ValueError(f"topk_retrieve: k >= 1 and a non-empty index, got k={k}")
    if queries.device.type == "cpu":
        return topk_retrieve_plain(queries, index, k)
    return _launch(queries, index, k)


topk_retrieve.launches = 0
topk_retrieve.bodies = dict.fromkeys(_BODIES, 0)


def topk_retrieve_reference(queries, index, k: int = 5):
    """The exact oracle: normalized query, fp32 product, sorted top-k."""
    sims = _normalize_div(queries) @ index.float().T
    return _sorted_topk(sims, min(k, index.shape[0]))


def topk_retrieve_midscale(queries, index, k: int = 5):
    """Mid band: one matmul (the normalized query cast to the index dtype,
    fp32 accumulation) and an exact sorted top-k. Not a kernel: the JAX
    package runs an XLA dot here too."""
    empty = _empty_if_k0(queries, k)
    if empty is not None:
        return empty
    sims = _normalize_div(queries).to(index.dtype).float() @ index.float().T
    return _sorted_topk(sims, min(k, index.shape[0]))


# ---------------------------------------------------------------------------
# Two-pass exact top-k at HBM scale
# ---------------------------------------------------------------------------
#
# pass 1  tile maxima of q·indexᵀ over `tile`-row tiles (a kernel on CUDA);
# pass 2  the k_sel tiles with the highest maxima. If row r is a true top-k
#         row, max(tile(r)) >= score(r) >= the kth score, and at most k tiles
#         can reach the kth score, so those tiles hold every top-k row. With
#         groups, the same argument one level up picks k_sel groups first;
# pass 3  rescore the k_sel·tile candidate rows, mask rows past n_valid, exact
#         top-k. Zero pad rows score 0 and can over-rank the tiles that hold
#         them, so k_sel = k + enough tiles to cover the pad region.


def _tile_view(scores: torch.Tensor, tile: int) -> torch.Tensor:
    """(Q, N) scores → (Q, nt, tile); rows past N are zero rows (score 0)."""
    Q, N = scores.shape
    nt = -(-N // tile)
    if nt * tile != N:
        scores = torch.nn.functional.pad(scores, (0, nt * tile - N))
    return scores.view(Q, nt, tile)


def _group_max(tmax: torch.Tensor, group: int) -> torch.Tensor:
    """(Q, nt) tile maxima → (Q, ceil(nt/group)) maxima of the tiles that exist."""
    Q, nt = tmax.shape
    ng = -(-nt // group)
    if ng * group != nt:
        tmax = torch.nn.functional.pad(tmax, (0, ng * group - nt), value=-float("inf"))
    return tmax.view(Q, ng, group).amax(2)


def _q8_scores_plain(qq, values, scales) -> torch.Tensor:
    """float(qq·valuesᵀ) · s_n: exact integers in fp32 (D <= 1024), then the
    per-row index scale; the per-query scale is left out."""
    return (qq.float() @ values.float().T) * scales.reshape(1, -1)


def tilemax_plain(qc, index, tile: int = 16) -> torch.Tensor:
    """The ``tilemax`` kernel's contract in plain PyTorch."""
    return _tile_view(qc.float() @ index.float().T, tile).amax(2)


def tilemax_sup_plain(qc, index, tile: int = 16, group: int = HIER_GROUP):
    """The ``tilemax_sup`` kernel's contract in plain PyTorch."""
    tmax = tilemax_plain(qc, index, tile)
    return tmax, _group_max(tmax, group)


def tilemax_sup_q8_plain(qq, values, scales, tile: int = 16, group: int = HIER_GROUP):
    """The ``tilemax_sup_q8`` kernel's contract in plain PyTorch."""
    tmax = _tile_view(_q8_scores_plain(qq, values, scales), tile).amax(2)
    return tmax, _group_max(tmax, group)


def _check_pass1(name, q, index, tile, group=None, scales=None):
    if q.dim() != 2 or index.dim() != 2 or q.shape[1] != index.shape[1]:
        raise ValueError(f"{name}: queries (Q, D) and index (N, D), got "
                         f"{tuple(q.shape)} and {tuple(index.shape)}")
    if q.device != index.device:
        raise ValueError(f"{name}: queries and index on different devices")
    if tile < 1 or (group is not None and not 1 <= group <= 1024):
        raise ValueError(f"{name}: tile >= 1 and 1 <= group <= 1024, got {tile}, {group}")
    if scales is None:
        if index.dtype not in _DTYPES or q.dtype != index.dtype:
            raise TypeError(f"{name}: an fp32 or bf16 index and queries of its type, "
                            f"got {q.dtype} and {index.dtype}")
    else:
        if q.dtype != torch.int8 or index.dtype != torch.int8:
            raise TypeError(f"{name}: int8 queries and values, got {q.dtype} and {index.dtype}")
        if scales.dtype != torch.float32 or scales.numel() != index.shape[0]:
            raise ValueError(f"{name}: fp32 scales with one entry per row")
    if q.device.type == "cpu":
        return
    row_bytes = index.shape[1] * index.element_size()
    if not index.is_contiguous() or row_bytes % 16 or index.data_ptr() % 16:
        raise ValueError(f"{name} kernel: a contiguous index with 16-byte aligned rows")
    if scales is not None and (not scales.is_contiguous() or index.shape[1] > 1024):
        raise ValueError(f"{name} kernel: contiguous scales and D <= 1024")


def _pass1_out(q, N, tile, group=None):
    nt = -(-N // tile)
    tmax = torch.empty((q.shape[0], nt), dtype=torch.float32, device=q.device)
    if group is None:
        return tmax, None
    gmax = torch.empty((q.shape[0], -(-nt // group)), dtype=torch.float32, device=q.device)
    return tmax, gmax


# -- the tile-max kernels' launch plan (csrc/retrieval_tilemax.cu) --------------

# From this many queries on, pass 1 takes the mma body (the crossover measured
# by ``chip_smoke.py --only tilemax``; PERF.md §6). Below it, the CUDA-core
# body, already at its byte bound at the seeker's Q = 1.
TILEMAX_MMA_MIN_Q = 9
_MMA_TILES = (8, 16)
_MMA_ROUND = 256  # rows of one round of an mma block: 8 warps x 2 fragments x 16
_MMA_CHUNK = 64  # bytes of a row per k-chunk
_PASS1_BODIES = {"cuda_core": 0, "mma": 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


class TilemaxPlan(NamedTuple):
    """How one pass-1 call (``tilemax``, ``tilemax_sup``, ``tilemax_sup_q8``)
    runs: the body (``mma``: tensor cores, a query block of 16, 32 or 64
    staged once, the index read once per query block; ``cuda_core``: FMA or
    ``__dp4a``, a query block of 1-8), the query block, the rows of one unit
    of work (mma: whole rounds and whole groups; cuda_core: one block's
    tiles), the most rows one block takes, the grid (index blocks, query
    blocks) and a block's shared memory."""

    body: str
    qb: int
    unit: int
    rows_per_block: int
    grid: tuple
    smem: int


def _mma_smem(qb: int, row_bytes: int, tile: int) -> int:
    """``mma_smem`` in the source: the staged query rows (stride 64 mod 128
    bytes) and two stages of tile maxima."""
    return qb * (_up(row_bytes, 128) + 64) + 2 * 4 * qb * (_MMA_ROUND // tile + 1)


def tilemax_plan(Q: int, N: int, D: int, dtype, tile: int, group: Optional[int],
                 sms: int) -> TilemaxPlan:
    """The launch plan of pass 1 over an fp32, bf16 or int8 index (``group``:
    None for ``tilemax``). Q >= ``TILEMAX_MMA_MIN_Q`` with a tile of 8 or 16 and
    rows of whole 64-byte k-chunks takes the mma body on the smallest query
    block of 16, 32, 64 that holds Q (64 above), halved while it does not fit
    ``SMEM_BLOCK`` (fp32 D = 1024: 32); the grid holds one block per SM
    divided among the query blocks, each taking an equal share of whole units.
    Every other shape, or one no query block fits, takes the CUDA-core body:
    a query block of 1, 2, 4 or 8, one block per ``group`` (else 16) tiles."""
    row_bytes = D * _ELEM_BYTES[dtype]
    nt = -(-N // tile)
    if Q >= TILEMAX_MMA_MIN_Q and tile in _MMA_TILES and row_bytes % _MMA_CHUNK == 0:
        qb = next(b for b in (16, 32, 64) if b >= min(Q, 64))
        while qb >= 16 and _mma_smem(qb, row_bytes, tile) > SMEM_BLOCK:
            qb //= 2
        if qb >= 16:
            unit = _MMA_ROUND if group is None else math.lcm(_MMA_ROUND, group * tile)
            units = -(-nt * tile // unit)
            gy = -(-Q // qb)
            gx = min(units, max(1, -(-sms // gy)))
            return TilemaxPlan("mma", qb, unit, -(-units // gx) * unit, (gx, gy),
                               _mma_smem(qb, row_bytes, tile))
    qb = 1 << (min(Q, 8) - 1).bit_length()
    tpb = 16 if group is None else group
    smem = _up(qb * row_bytes, 16) + (4 * qb * tpb if group is not None else 0)
    return TilemaxPlan("cuda_core", qb, tpb * tile, tpb * tile, (-(-nt // tpb), -(-Q // qb)), smem)


# tilemax_fwd(queries, index, tmax, Q, N, D, tile, index_dtype, body, qb,
#             unit_rows, grid_x, stream); tilemax_sup_fwd adds gmax after
# tmax and group after tile; tilemax_sup_q8_fwd(queries, values, scales, tmax,
# gmax, Q, N, D, tile, group, body, qb, unit_rows, grid_x, stream)
_TILEMAX_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_TILEMAX_SUP_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_TILEMAX_SUP_Q8_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)


def _pass1_launch(qc, index, tile: int, group: Optional[int], plan: TilemaxPlan, scales=None):
    """Launch ``tilemax_fwd`` (``group`` None), ``tilemax_sup_fwd`` or, given
    ``scales``, ``tilemax_sup_q8_fwd`` on CUDA tensors with ``plan``; returns
    (tmax, gmax or None)."""
    (Q, D), N = qc.shape, index.shape[0]
    if plan.body == "mma" and qc.data_ptr() % 16:  # the query block is staged in 16-byte vectors
        qc = qc.clone()
    tmax, gmax = _pass1_out(qc, N, tile, group)
    how = (_PASS1_BODIES[plan.body], plan.qb, plan.unit, plan.grid[0], _build.stream_ptr(qc))
    if scales is not None:
        rc = _build.function("retrieval_tilemax", "tilemax_sup_q8_fwd", _TILEMAX_SUP_Q8_ARGS)(
            qc.data_ptr(), index.data_ptr(), scales.data_ptr(), tmax.data_ptr(), gmax.data_ptr(),
            Q, N, D, tile, group, *how)
        _build.check(rc, "tilemax_sup_q8_fwd")
    elif group is None:
        rc = _build.function("retrieval_tilemax", "tilemax_fwd", _TILEMAX_ARGS)(
            qc.data_ptr(), index.data_ptr(), tmax.data_ptr(), Q, N, D, tile,
            _DTYPES[index.dtype], *how)
        _build.check(rc, "tilemax_fwd")
    else:
        rc = _build.function("retrieval_tilemax", "tilemax_sup_fwd", _TILEMAX_SUP_ARGS)(
            qc.data_ptr(), index.data_ptr(), tmax.data_ptr(), gmax.data_ptr(), Q, N, D, tile,
            group, _DTYPES[index.dtype], *how)
        _build.check(rc, "tilemax_sup_fwd")
    return tmax, gmax


def _pass1_plan(qc, index, tile, group) -> TilemaxPlan:
    (Q, D), N = qc.shape, index.shape[0]
    return tilemax_plan(Q, N, D, index.dtype, tile, group, _build.sm_count(qc.device))


def tilemax(qc: torch.Tensor, index: torch.Tensor, tile: int = 16) -> torch.Tensor:
    """Pass-1 tile maxima (Q, ceil(N/tile)) fp32 of ``qc·indexᵀ``, ``qc`` the
    normalized queries cast to the index type. CUDA tensors launch the
    kernel on the body ``tilemax_plan`` picks (``launches`` counts the calls,
    ``bodies`` the body each took); CPU tensors run ``tilemax_plain``."""
    _check_pass1("tilemax", qc, index, tile)
    if qc.device.type == "cpu":
        return tilemax_plain(qc, index, tile)
    qc = qc.contiguous()
    plan = _pass1_plan(qc, index, tile, None)
    tmax, _ = _pass1_launch(qc, index, tile, None, plan)
    tilemax.launches += 1
    tilemax.bodies[plan.body] += 1
    return tmax


tilemax.launches = 0
tilemax.bodies = dict.fromkeys(_PASS1_BODIES, 0)


def tilemax_sup(qc, index, tile: int = 16, group: int = HIER_GROUP):
    """``tilemax`` plus the maxima of each ``group`` consecutive tiles,
    (Q, ceil(nt/group)), written in the same pass."""
    _check_pass1("tilemax_sup", qc, index, tile, group)
    if qc.device.type == "cpu":
        return tilemax_sup_plain(qc, index, tile, group)
    qc = qc.contiguous()
    plan = _pass1_plan(qc, index, tile, group)
    tmax, gmax = _pass1_launch(qc, index, tile, group, plan)
    tilemax_sup.launches += 1
    tilemax_sup.bodies[plan.body] += 1
    return tmax, gmax


tilemax_sup.launches = 0
tilemax_sup.bodies = dict.fromkeys(_PASS1_BODIES, 0)


def tilemax_sup_q8(qq, values, scales, tile: int = 16, group: int = HIER_GROUP,
                   mxu: str = "int8"):
    """``tilemax_sup`` over an int8 index: float(int32 dot) times the row's
    scale (the query's scale left out), tile and group maxima, bit-equal to
    ``tilemax_sup_q8_plain``. CUDA tensors launch the kernel on the body
    ``tilemax_plan`` picks, both taking the exact int32 dot (``__dp4a`` on
    the CUDA-core body, ``mma.sync`` s8 on the mma body); ``launches`` counts
    the calls, ``bodies`` the body each took. ``mxu`` (``"int8"`` or
    ``"bf16"``) chose the TPU's MXU operand type; it is checked for parity
    and does not apply on CUDA."""
    if mxu not in _Q8_MXU:
        raise ValueError(f"bad mxu mode {mxu!r}")
    _check_pass1("tilemax_sup_q8", qq, values, tile, group, scales)
    if qq.device.type == "cpu":
        return tilemax_sup_q8_plain(qq, values, scales, tile, group)
    qq = qq.contiguous()
    plan = _pass1_plan(qq, values, tile, group)
    tmax, gmax = _pass1_launch(qq, values, tile, group, plan, scales)
    tilemax_sup_q8.launches += 1
    tilemax_sup_q8.bodies[plan.body] += 1
    return tmax, gmax


tilemax_sup_q8.launches = 0
tilemax_sup_q8.bodies = dict.fromkeys(_PASS1_BODIES, 0)


def _slack(N: int, tile: int, n_valid) -> tuple[int, int, int]:
    """(nt, k_sel - k, n_valid): selection slack for the contiguous zero
    region at the end (tile padding plus rows past ``n_valid``)."""
    nt = -(-N // tile)
    nv = N if n_valid is None else int(n_valid)
    pad = nt * tile - N + (N - nv)
    return nt, ((-(-pad // tile) + 1) if pad > 0 else 0), nv


def _kernel_pass1(queries: torch.Tensor) -> bool:
    """The default pass-1 route: the kernel for every CUDA tensor. The JAX
    package's further conditions (D % 128, tile % 8, tile <= 16) come from
    Mosaic's 128-lane tiling and do not bind the CUDA kernel; the wrappers
    raise on the shapes it cannot take."""
    return queries.device.type == "cuda"


def _nt_main(N: int, tile: int) -> int:
    """Tiles in the JAX kernel's 128-tile-aligned main part (its gates)."""
    bn = 128 * tile
    return (N // bn) * bn // tile


def _hier(N: int, tile: int, group: int, k_sel: int) -> bool:
    """The JAX package's hierarchical gate (ops/retrieval_topk.py:589-599)."""
    nt_main = _nt_main(N, tile)
    return (group > 1 and nt_main > 0 and 128 % group == 0 and (128 // group) % 8 == 0
            and nt_main % group == 0 and nt_main // group >= min(k_sel, nt_main))


def _check_group(group):
    if group is not None and group > 1 and 128 % group != 0:
        raise ValueError(f"group={group} must divide 128")


def _select_flat(tmax: torch.Tensor, k_sel: int) -> torch.Tensor:
    return torch.topk(tmax, k_sel, dim=1).indices


def _select_hier(tmax: torch.Tensor, gmax: torch.Tensor, group: int, k_sel: int):
    """Pass 2 through the group maxima: the top groups, then the top tiles
    inside them."""
    Q, nt = tmax.shape
    gids = torch.topk(gmax, min(k_sel, gmax.shape[1]), dim=1).indices
    tids = (gids[:, :, None] * group + torch.arange(group, device=tmax.device)).reshape(Q, -1)
    tvals = tmax.gather(1, tids.clamp(max=nt - 1)).masked_fill(tids >= nt, -float("inf"))
    return tids.gather(1, torch.topk(tvals, k_sel, dim=1).indices)


def _candidates(tile_ids: torch.Tensor, tile: int, N: int) -> torch.Tensor:
    """Selected tiles → (Q, k_sel·tile) row ids (past N where a tile is padded)."""
    nt = -(-N // tile)
    tile_ids = tile_ids.clamp(max=nt - 1).long()
    flat = tile_ids[:, :, None] * tile + torch.arange(tile, device=tile_ids.device)
    return flat.reshape(tile_ids.shape[0], -1)


def _pass3_topk(cand: torch.Tensor, flat: torch.Tensor, n_valid: int, k: int):
    """Mask rows at or past ``n_valid``; exact top-k, ties to the earlier
    candidate as ``lax.top_k`` breaks them."""
    cand = cand.masked_fill(flat >= n_valid, NEG_INF)
    s, pos = torch.sort(cand, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), flat.gather(1, pos[:, :k]).to(torch.int32)


def topk_retrieve_twopass(
    queries: torch.Tensor,
    index: torch.Tensor,
    k: int = 10,
    tile: int = 16,
    n_valid: Optional[int] = None,
    pallas_pass1: Optional[bool] = None,
    group: Optional[int] = None,
):
    """Exact top-k for HBM-scale fp32/bf16 indexes (``topk_retrieve``'s
    contract, the normalized query cast to the index dtype before scoring).

    ``n_valid``: rows at or past it never appear. ``pallas_pass1``: run pass 1
    through the ``tilemax``/``tilemax_sup`` wrappers (kernels on CUDA, their
    plain versions on the CPU) instead of the plain fused form; ``None`` = on
    for CUDA tensors, off on the CPU. ``group``: hierarchical pass-2 width; ``None``
    = 16 from ``HIER_MIN_TILES`` main-part tiles on, ``0``/``1`` = off.
    """
    empty = _empty_if_k0(queries, k)
    if empty is not None:
        return empty
    N = index.shape[0]
    k = min(k, N)
    nt, extra, nv = _slack(N, tile, n_valid)
    k_sel = k + extra
    if nt < k_sel:  # fewer tiles than the selection needs: the oracle is exact
        # rows past n_valid are masked before the selection, so none takes a
        # slot from a real row (the JAX package masks after its top-k)
        sims = _normalize_div(queries) @ index.float().T
        sims[:, nv:] = NEG_INF
        return _sorted_topk(sims, k)
    if pallas_pass1 is None:
        pallas_pass1 = _kernel_pass1(queries)
    _check_group(group)
    if group is None:
        group = HIER_GROUP if pallas_pass1 and _nt_main(N, tile) >= HIER_MIN_TILES else 0
    qc = _normalize(queries).to(index.dtype)
    if not pallas_pass1:
        tile_ids = _select_flat(tilemax_plain(qc, index, tile), k_sel)
    elif _hier(N, tile, group, k_sel):
        tile_ids = _select_hier(*tilemax_sup(qc, index, tile, group), group, k_sel)
    else:
        tile_ids = _select_flat(tilemax(qc, index, tile), k_sel)
    flat = _candidates(tile_ids, tile, N)
    rows = index[flat.clamp(max=N - 1)].float()  # (Q, k_sel·tile, D)
    cand = torch.bmm(rows, qc.float()[:, :, None])[..., 0]
    return _pass3_topk(cand, flat, nv, k)


# ---------------------------------------------------------------------------
# Int8-quantized index
# ---------------------------------------------------------------------------
#
# Symmetric per-row scales on both sides, s = max|x| / 127, xq = round(x / s);
# scores (qq·xq)·s_n·s_q. Selection is exact over the quantized scores: the
# int32 dot is exact, and D <= 1024 keeps every sum below 2^24, so the fp32
# rescore of pass 3 reproduces pass 1's maxima bit for bit.


def quantize_index_int8(index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) float index → (values int8 (N, D), scales fp32 (N, 1))."""
    x = index.float()
    s = x.abs().amax(1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def _quantize_queries(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize (cosine contract), then int8-quantize per query row."""
    q = _normalize(queries)
    s_q = q.abs().amax(1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(q / s_q), -127, 127).to(torch.int8), s_q


def topk_retrieve_q8(
    queries: torch.Tensor,
    values: torch.Tensor,
    scales: torch.Tensor,
    k: int = 10,
    tile: int = 16,
    n_valid: Optional[int] = None,
    pallas_pass1: Optional[bool] = None,
    group: Optional[int] = None,
    mxu: str = "int8",
):
    """Two-pass top-k over an int8 index from ``quantize_index_int8``;
    selection exact over the quantized scores, which are returned. Other
    arguments as ``topk_retrieve_twopass``; ``mxu`` as ``tilemax_sup_q8``.
    With ``pallas_pass1`` the flat route (below the hierarchical gate) takes
    its tile maxima from ``tilemax_sup_q8`` too, so pass 1 reads the int8
    bytes once; the JAX package runs its fused XLA form there, which gives the
    same maxima."""
    if mxu not in _Q8_MXU:
        raise ValueError(f"bad mxu mode {mxu!r}")
    empty = _empty_if_k0(queries, k)
    if empty is not None:
        return empty
    if queries.shape[1] > 1024:
        raise ValueError(
            f"topk_retrieve_q8 requires D <= 1024 (got D={queries.shape[1]}): "
            "int8 dot sums exceed 2^24 and the fp32 rescore is no longer "
            "bit-exact vs pass 1. Use topk_retrieve/topk_retrieve_twopass."
        )
    N = values.shape[0]
    k = min(k, N)
    nt, extra, nv = _slack(N, tile, n_valid)
    k_sel = k + extra
    qq, s_q = _quantize_queries(queries)
    if nt < k_sel:  # tiny index: the dequantized oracle, same scale order
        sims = (qq.float() @ values.float().T) * scales[:, 0][None, :] * s_q
        if n_valid is not None:
            sims[:, nv:] = NEG_INF
        return _sorted_topk(sims, k)
    if pallas_pass1 is None:
        pallas_pass1 = _kernel_pass1(queries)
    _check_group(group)
    if group is None:
        group = HIER_GROUP if pallas_pass1 and _nt_main(N, tile) >= Q8_HIER_MIN_TILES else 0
    if pallas_pass1:
        hier = _hier(N, tile, group, k_sel)

        def select(chunk):  # the flat route ignores the group maxima
            tmax, gmax = tilemax_sup_q8(chunk, values, scales, tile,
                                        group if hier else HIER_GROUP, mxu)
            return _select_hier(tmax, gmax, group, k_sel) if hier else _select_flat(tmax, k_sel)

        # the (Q, nt) maxima stay under _Q8_MAXIMA_BYTES: query chunks, each
        # streaming the index again
        Q = qq.shape[0]
        cq = Q
        if 4 * nt * Q > _Q8_MAXIMA_BYTES and Q > _Q8_MIN_CHUNK:
            cq = max(_Q8_MIN_CHUNK,
                     (_Q8_MAXIMA_BYTES // (4 * nt)) // _Q8_MIN_CHUNK * _Q8_MIN_CHUNK)
        tile_ids = torch.cat([select(qq[i:i + cq]) for i in range(0, Q, cq)])
    else:
        tmax = _tile_view(_q8_scores_plain(qq, values, scales), tile).amax(2)
        tile_ids = _select_flat(tmax, k_sel)
    flat = _candidates(tile_ids, tile, N)
    safe = flat.clamp(max=N - 1)
    cand = torch.bmm(values[safe].float(), qq.float()[:, :, None])[..., 0]
    cand = (cand * scales.reshape(-1)[safe]) * s_q
    return _pass3_topk(cand, flat, nv, k)


def topk_retrieve_auto(queries, index, k: int = 5):
    """Size bands of the JAX package: streaming kernel below
    ``MIDSCALE_MIN_N`` (and for fp32 up to ``TWOPASS_MIN_N``), the mid-band
    matmul for bf16 in between, two-pass at and above ``TWOPASS_MIN_N``.

    Below ``TWOPASS_MIN_N`` a ``k`` past the kernel's ``K_MAX`` takes the
    exact mid-band route (one matmul, a stable sort, ties to the lower id):
    the kernel's contract for an fp32 index; for a bf16 index the query is
    cast to bf16 first, as the mid band does. ``k == 0`` gives (Q, 0) and
    ``k < 0`` raises on every band."""
    empty = _empty_if_k0(queries, k)
    if empty is not None:
        return empty
    n = index.shape[0]
    if n >= TWOPASS_MIN_N:
        return topk_retrieve_twopass(queries, index, k)
    if (n >= MIDSCALE_MIN_N and index.dtype == torch.bfloat16) or k > K_MAX:
        return topk_retrieve_midscale(queries, index, k)
    return topk_retrieve(queries, index, k)
