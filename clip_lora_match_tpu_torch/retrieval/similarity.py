"""Cosine similarity + exact top-k retrieval (port of
``retrieval/similarity.py``).

On CUDA every search goes through ``ops.retrieval_topk.topk_retrieve_auto``
at every N (the JAX package's ``n >= 2048`` gate was a TPU VMEM measurement
and is not carried over). On the CPU the plain path is the JAX package's
CPU path: normalize, one product, exact top-k (ties to the lower id).
``approximate=True`` selects through ``ops.approx_topk`` (XLA's ApproxTopK
binning; the bin-max kernel on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def cosine_similarity(
    query: torch.Tensor | np.ndarray, candidates: torch.Tensor | np.ndarray
) -> torch.Tensor:
    """(D,)|(Q, D) × (N, D) → (N,)|(Q, N) fp32 cosine scores."""
    query = torch.as_tensor(query)
    q = l2_normalize(torch.atleast_2d(query).float())
    c = l2_normalize(torch.as_tensor(candidates, device=q.device).float())
    sims = q @ c.T
    return sims[0] if query.dim() == 1 else sims


def top_k_similar(
    query: torch.Tensor | np.ndarray,
    candidates: torch.Tensor,
    k: int = 5,
    assume_normalized: bool = False,
    approximate: bool = False,
    recall_target: float = 0.95,
) -> tuple[np.ndarray, np.ndarray]:
    """→ (scores, indices) as numpy, k clamped to N; ``k == 0`` gives empty
    results and ``k < 0`` raises (``lax.top_k``'s contract in the JAX
    package). ``approximate=True`` trades recall for speed at
    ``recall_target`` (the expected recall of the exact top-k;
    ``recall_target=1.0`` is exact)."""
    n = candidates.shape[0]
    if n == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int32)
    if k < 0:
        raise ValueError(f"top_k_similar: k must be nonnegative, got {k}")
    k = min(k, n)
    query = torch.as_tensor(query, dtype=torch.float32, device=candidates.device)
    single = query.dim() == 1
    q2 = torch.atleast_2d(query)
    if approximate:
        from clip_lora_match_tpu_torch.ops.approx_topk import approx_topk

        cand = candidates if assume_normalized else l2_normalize(candidates.float())
        scores, idx = approx_topk(q2, cand, k, recall_target)
    elif candidates.device.type == "cuda":
        from clip_lora_match_tpu_torch.ops.retrieval_topk import topk_retrieve_auto

        cand = candidates if assume_normalized else l2_normalize(candidates.float())
        scores, idx = topk_retrieve_auto(q2, cand, k)
    else:
        cand = candidates.float() if assume_normalized else l2_normalize(candidates.float())
        sims = l2_normalize(q2) @ cand.T
        scores, idx = torch.sort(sims, dim=1, descending=True, stable=True)
        scores, idx = scores[:, :k], idx[:, :k].to(torch.int32)
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
    if single:
        return scores[0], idx[0]
    return scores, idx
