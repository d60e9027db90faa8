"""Exact top-k over an index whose rows are split over the ranks (port of
``retrieval/sharded.py``).

Each rank holds its contiguous shard of the padded index on its device
(``shard_index``: rows ``[r·N/n, (r+1)·N/n)``), runs the single-device
exact search over it, offsets its ids by ``r·N/n``, and the ranks'
(Q, k) candidates are all-gathered and merged by one exact top-k. The
communication is O(Q·k·n), whatever N.

- On CUDA each shard takes the two-pass route (``topk_retrieve_twopass``,
  ``topk_retrieve_q8``): pass 1 on the tile-max kernels, the body their plan
  picks. On the CPU the plain route (one product, the shard's pad rows set
  to the lowest score, a sorted top-k); ``use_kernel=True`` there runs the
  two-pass route with its plain pass 1.
- Pad rows (zero rows from ``pad_to_multiple``, at the end of the last
  shard) never take a slot in a shard's k: a zero row scores 0, which
  outranks genuinely negative candidates. Each rank knows its own count of
  valid rows, ``clip(n_valid - r·N/n, 0, N/n)``, as a Python int, and the
  two-pass routes size their selection slack from it. The JAX package's
  route without a kernel masks the pad rows after the shard's top-k, so a
  pad row can still evict a real candidate there; the port masks first.
- The merge keeps ``lax.top_k``'s order over the rank-major concatenation:
  at equal scores the lower position, which is the lower global id, comes
  first (a stable descending sort). Every rank returns the same (Q, k).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from clip_lora_match_tpu_torch.ops.retrieval_topk import (
    NEG_INF,
    _normalize_div,
    _sorted_topk,
    topk_retrieve_q8,
    topk_retrieve_twopass,
)
from clip_lora_match_tpu_torch.parallel.mesh import Mesh, all_gather, make_mesh


def shard_index(mesh: Mesh, index) -> torch.Tensor:
    """This rank's rows of the (N, D) index (numpy or a tensor, the whole
    index on every rank; N must divide over the ranks: pad with
    ``parallel.mesh.pad_to_multiple`` first), on its device."""
    N = index.shape[0]
    if N % mesh.n_data:
        raise ValueError(f"shard_index: {N} rows do not split over {mesh.n_data} ranks "
                         "(pad_to_multiple first)")
    n = N // mesh.n_data
    rows = index[mesh.rank * n:(mesh.rank + 1) * n]
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(mesh.device).contiguous()


def shard_index_q8(mesh: Mesh, values, scales) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows of an int8 index (values (N, D) int8, scales (N, 1)
    fp32 from ``ops.retrieval_topk.quantize_index_int8``, padded with zero
    values and zero scales). Per-row scales make sharding commute with
    quantization."""
    return shard_index(mesh, values), shard_index(mesh, scales)


def _local_valid(mesh: Mesh, shard_n: int, n_valid: Optional[int], max_pad: Optional[int]) -> int:
    N = shard_n * mesh.n_data
    nv = N if n_valid is None else int(n_valid)
    if not 0 <= nv <= N:
        raise ValueError(f"n_valid={nv} outside [0, {N}]")
    if max_pad is not None and N - nv > max_pad:
        raise ValueError(f"{N - nv} pad rows exceed max_pad={max_pad}")
    return min(max(nv - mesh.rank * shard_n, 0), shard_n)


def merge_candidates(mesh: Mesh, scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Each rank's (Q, k_r) scores and global ids → the exact (Q, k) over all
    ranks, the same on every rank; ties to the lower rank-major position."""
    s_all = all_gather(mesh, scores.t().contiguous()).t()  # (Q, n·k_r), rank-major
    i_all = all_gather(mesh, ids.t().contiguous()).t()
    s, pos = torch.sort(s_all, dim=1, descending=True, stable=True)
    k = min(k, s_all.shape[1])
    return s[:, :k].contiguous(), i_all.gather(1, pos[:, :k]).to(torch.int32)


def _check_k(k: int, shard_n: int) -> None:
    if k < 0:
        raise ValueError(f"top-k: k must be nonnegative, got {k}")
    if shard_n < k:
        raise ValueError(f"each shard must hold at least k={k} rows, got {shard_n}")


def _check_route(shard: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        return shard.device.type == "cuda"
    if shard.device.type == "cuda" and not use_kernel:
        raise ValueError("sharded top-k on a CUDA shard runs pass 1 on the kernels; use_kernel=False "
                         "is the CPU's plain route")
    return bool(use_kernel)


def sharded_topk_retrieve(
    queries,
    index: torch.Tensor,
    k: int = 10,
    mesh: Optional[Mesh] = None,
    n_valid: Optional[int] = None,
    use_kernel: Optional[bool] = None,
    max_pad: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an index split over the ranks.

    queries: (Q, D), the same on every rank (numpy or a tensor).
    index:   this rank's shard (``shard_index``), fp32 or bf16, N_padded / n
             rows, at least k of them.
    n_valid: the true row count of the padded index.
    use_kernel: the two-pass route on each shard; None = on CUDA shards.
    max_pad: an upper bound on the pad rows, kept for the JAX package's
             callers and only checked.
    Returns (scores (Q, k) fp32, global ids (Q, k) int32), sorted descending.
    """
    mesh = mesh or make_mesh(device=index.device)
    shard_n = index.shape[0]
    _check_k(k, shard_n)
    local = _local_valid(mesh, shard_n, n_valid, max_pad)
    q = torch.as_tensor(queries).to(index.device)
    if _check_route(index, use_kernel):
        s, i = topk_retrieve_twopass(q, index, k, n_valid=local)
    else:
        sims = _normalize_div(q) @ index.float().T
        sims[:, local:] = NEG_INF
        s, i = _sorted_topk(sims, k)
    return merge_candidates(mesh, s, i.long() + mesh.rank * shard_n, k)


def sharded_topk_retrieve_q8(
    queries,
    values: torch.Tensor,
    scales: torch.Tensor,
    k: int = 10,
    mesh: Optional[Mesh] = None,
    n_valid: Optional[int] = None,
    max_pad: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int8 index split over the ranks: ``topk_retrieve_q8`` on
    each shard (selection exact over the quantized scores; pass 1 on the
    kernel on CUDA, plain on the CPU), then the same merge. Arguments as
    ``sharded_topk_retrieve``."""
    mesh = mesh or make_mesh(device=values.device)
    shard_n = values.shape[0]
    _check_k(k, shard_n)
    local = _local_valid(mesh, shard_n, n_valid, max_pad)
    q = torch.as_tensor(queries).to(values.device)
    s, i = topk_retrieve_q8(q, values, scales, k, n_valid=local)
    return merge_candidates(mesh, s, i.long() + mesh.rank * shard_n, k)
