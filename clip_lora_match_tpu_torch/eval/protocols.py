"""Retrieval evaluation protocols (port of ``eval/protocols.py``).

Two protocols, as the reference's two evaluators:

1. **Diagonal ground truth** (ref:scripts/evaluate_model.py:38-107): the i-th
   image matches the i-th caption. recall@k = diagonal-in-top-k, MRR, mAP =
   mean(1/rank), matching accuracy = argmax == diagonal; for both image→text
   and text→image over the (N, N) similarity matrix.
2. **Threshold relevance** (ref:scripts/evaluate.py:24,141-168): any index
   item with cosine >= 0.7 to the query counts as relevant; recall and
   precision@k against that set, MRR of the first relevant hit, average
   precision, plus ``avg_query_time_ms`` (ref L231-266).

The similarity matrix is one fp32 product on ``device`` (TF32 off whatever
the process's setting); the metric math runs on the host in numpy, as in the
JAX package, so the same embeddings give the JAX package's numbers.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def _true_fp32():
    """TF32 off for the products inside, then the setting as it was."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _unit_rows(x) -> torch.Tensor | np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float()
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def similarity_matrix(a, b, device: Optional[str | torch.device] = None) -> np.ndarray:
    """Cosine similarity matrix (normalizes defensively): numpy arrays or
    tensors → (A, B) fp32 numpy. The product runs on ``device``, by default
    the device of ``a`` when it is a tensor, else the CPU."""
    if device is None:
        device = a.device if isinstance(a, torch.Tensor) else "cpu"
    a, b = (torch.as_tensor(_unit_rows(x)).to(device) for x in (a, b))
    with _true_fp32():
        return (a @ b.T).cpu().numpy()


def _diagonal_ranks(sim: np.ndarray) -> np.ndarray:
    """1-based rank of the diagonal entry within each row (ties: items with a
    strictly greater score outrank the target)."""
    diag = np.diagonal(sim)
    return 1 + (sim > diag[:, None]).sum(axis=1)


def diagonal_metrics(
    image_embeds,
    text_embeds,
    ks: Sequence[int] = (1, 5, 10),
    device: Optional[str | torch.device] = None,
) -> dict:
    """Both-direction diagonal-GT metrics in the model_comparison.json shape
    (keys: recall@k, mrr, map, t2i_recall@k, matching_accuracy)."""
    sim = similarity_matrix(image_embeds, text_embeds, device)  # (N, N) i2t
    out: dict = {}
    i2t_ranks = _diagonal_ranks(sim)
    for k in ks:
        out[f"recall@{k}"] = float((i2t_ranks <= k).mean())
    out["mrr"] = float((1.0 / i2t_ranks).mean())
    out["map"] = out["mrr"]  # one relevant item: AP == 1/rank (ref L92-107)
    t2i_ranks = _diagonal_ranks(sim.T)
    for k in ks:
        out[f"t2i_recall@{k}"] = float((t2i_ranks <= k).mean())
    out["matching_accuracy"] = float(
        (np.argmax(sim, axis=1) == np.arange(sim.shape[0])).mean()
    )
    return out


def threshold_metrics(
    query_embeds,
    index_embeds,
    ks: Sequence[int] = (1, 5, 10),
    threshold: float = 0.7,
    exclude_self: bool = False,
    measure_latency: bool = True,
    device: Optional[str | torch.device] = None,
) -> dict:
    """Threshold-relevance protocol over an index (ref:scripts/evaluate.py)."""
    t0 = time.perf_counter()
    sim = similarity_matrix(query_embeds, index_embeds, device)  # (Q, N)
    if exclude_self and sim.shape[0] == sim.shape[1]:
        np.fill_diagonal(sim, -np.inf)
    elapsed_ms = (time.perf_counter() - t0) * 1000.0

    Q, N = sim.shape
    order = np.argsort(-sim, axis=1)  # (Q, N) descending
    relevant = sim >= threshold
    n_rel = relevant.sum(axis=1)  # (Q,)
    ranked_rel = np.take_along_axis(relevant, order, axis=1)  # (Q, N) bool

    out: dict = {}
    valid = n_rel > 0
    for k in ks:
        hits = ranked_rel[:, :k].sum(axis=1)
        rec = np.where(valid, hits / np.maximum(n_rel, 1), 0.0)
        out[f"recall@{k}"] = float(rec[valid].mean()) if valid.any() else 0.0
        out[f"precision@{k}"] = float((hits / k)[valid].mean()) if valid.any() else 0.0
    # MRR: the first relevant position
    first = np.where(ranked_rel.any(axis=1), ranked_rel.argmax(axis=1) + 1, np.inf)
    out["mrr"] = float(np.where(valid, 1.0 / first, 0.0)[valid].mean()) if valid.any() else 0.0
    # AP per query
    cum = np.cumsum(ranked_rel, axis=1)
    prec_at = cum / np.arange(1, N + 1)[None, :]
    ap = (prec_at * ranked_rel).sum(axis=1) / np.maximum(n_rel, 1)
    out["ap"] = float(ap[valid].mean()) if valid.any() else 0.0
    out["num_queries"] = int(Q)
    out["num_queries_with_relevant"] = int(valid.sum())
    if measure_latency:
        out["avg_query_time_ms"] = float(elapsed_ms / max(Q, 1))
    return out


def relative_improvement(base: dict, tuned: dict) -> dict:
    """Percent improvement per shared numeric metric (ref:compare_models.py:251-300)."""
    out = {}
    for k, v in base.items():
        if isinstance(v, (int, float)) and k in tuned and v:
            out[k] = (tuned[k] - v) / abs(v) * 100.0
    return out
