"""Qualitative evaluation: failure-case grids and the embedding-space plot
(port of ``eval/qualitative.py``).

ref:scripts/qualitative_evaluation.py: failure score = rank − correct_score
(ref L117-130), top-k grids with ✓/✗ markers (ref L137-226), a t-SNE plot
of the joint embedding space (ref L228-337). Without matplotlib the plots
are skipped (``[]`` / None); without sklearn the projection is PCA.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from clip_lora_match_tpu_torch.core.logging import get_logger
from clip_lora_match_tpu_torch.eval.protocols import similarity_matrix

log = get_logger("qualitative")


@dataclass
class FailureCase:
    query_index: int
    query_text: str
    correct_rank: int
    correct_score: float
    failure_score: float
    top_k: list[int]
    top_k_scores: list[float]


def find_failure_cases(
    image_embeds,
    text_embeds,
    texts: Sequence[str],
    num_cases: int = 10,
    k: int = 5,
    device: Optional[str | torch.device] = None,
) -> list[FailureCase]:
    """The worst diagonal-GT failures, ranked by rank − correct_score
    (ref L117-130). Direction: a text query ranks the images (the demo's
    use)."""
    sim = similarity_matrix(text_embeds, image_embeds, device)  # (N, N) t2i
    diag = np.diagonal(sim)
    ranks = 1 + (sim > diag[:, None]).sum(axis=1)
    failure = ranks - diag
    order = np.argsort(-failure)
    cases = []
    topk_idx = np.argsort(-sim, axis=1)[:, :k]
    for i in order[:num_cases]:
        cases.append(
            FailureCase(
                query_index=int(i),
                query_text=str(texts[i]) if i < len(texts) else "",
                correct_rank=int(ranks[i]),
                correct_score=float(diag[i]),
                failure_score=float(failure[i]),
                top_k=[int(j) for j in topk_idx[i]],
                top_k_scores=[float(sim[i, j]) for j in topk_idx[i]],
            )
        )
    return cases


def plot_failure_grids(
    cases: list[FailureCase],
    image_paths: Sequence[str],
    out_dir: str,
    k: int = 5,
) -> list[str]:
    """Query and its top-k retrieved images with ✓/✗ markers (ref L137-226)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from PIL import Image
    except ImportError:
        return []
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for ci, case in enumerate(cases):
        fig, axes = plt.subplots(1, k, figsize=(3 * k, 3.6))
        axes = np.atleast_1d(axes)
        for rank, (idx, score) in enumerate(zip(case.top_k, case.top_k_scores)):
            ax = axes[rank]
            try:
                ax.imshow(Image.open(image_paths[idx]).convert("RGB"))
            except Exception:
                ax.text(0.5, 0.5, "missing", ha="center")
            ok = idx == case.query_index
            ax.set_title(f"{'✓' if ok else '✗'} #{rank + 1} ({score:.3f})", color="green" if ok else "red")
            ax.axis("off")
        fig.suptitle(
            f"Query: {case.query_text[:80]}\n"
            f"correct rank {case.correct_rank}, failure {case.failure_score:.2f}"
        )
        p = os.path.join(out_dir, f"failure_{ci:02d}.png")
        fig.savefig(p, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(p)
    return written


def plot_embedding_space(
    image_embeds: np.ndarray,
    text_embeds: np.ndarray,
    out_path: str,
    method: str = "tsne",
    max_points: int = 1000,
    seed: int = 42,
) -> Optional[str]:
    """Joint t-SNE or PCA projection of both towers' embeddings (ref L228-337)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    n = min(max_points, image_embeds.shape[0])
    rng = np.random.default_rng(seed)
    pick = rng.choice(image_embeds.shape[0], n, replace=False)
    joint = np.concatenate([image_embeds[pick], text_embeds[pick]])
    if method not in ("tsne", "pca"):
        raise ValueError(f"unknown projection method {method!r} (tsne|pca)")
    if method == "tsne":
        try:
            from sklearn.manifold import TSNE

            proj = TSNE(
                n_components=2, random_state=seed, perplexity=min(30, max(2, n // 4)),
            ).fit_transform(joint)
        except ImportError:
            method = "pca"
    if method == "pca":
        centered = joint - joint.mean(0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        proj = centered @ vt[:2].T
    fig, ax = plt.subplots(figsize=(10, 8))
    ax.scatter(proj[:n, 0], proj[:n, 1], s=8, alpha=0.6, label="images")
    ax.scatter(proj[n:, 0], proj[n:, 1], s=8, alpha=0.6, label="texts")
    ax.legend()
    ax.set_title(f"Embedding space ({method})")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path
