"""Exact top-k by cosine over an index given in blocks, in fp32 with TF32
off, plus the exact score of given row ids. Imports nothing of the port."""

from __future__ import annotations

import torch

from gpu_bench.reference.clip import precision


def exact_topk(queries: torch.Tensor, blocks, k: int, ids: torch.Tensor | None = None):
    """``queries`` (Q, D) unit rows; ``blocks`` yields (start, rows) of unit
    rows. → (top scores (Q, k), top ids (Q, k), scores of ``ids`` (Q, m)).
    Ties order by the lower id."""
    Q = queries.shape[0]
    best_s = torch.full((Q, 0), float("-inf"), device=queries.device)
    best_i = torch.zeros((Q, 0), dtype=torch.int64, device=queries.device)
    own = None if ids is None else torch.full(ids.shape, float("nan"), device=queries.device)
    with precision(False):
        for start, rows in blocks:
            s = queries @ rows.t()
            n = rows.shape[0]
            if ids is not None:
                inside = (ids >= start) & (ids < start + n)
                local = (ids - start).clamp(0, n - 1)
                own = torch.where(inside, s.gather(1, local), own)
            ts, ti = torch.topk(s, min(k, n), dim=1)
            cat_s = torch.cat([best_s, ts], 1)
            cat_i = torch.cat([best_i, ti + start], 1)
            # sort by score, then by id, so that ties keep the lower id
            order = torch.argsort(cat_i, dim=1, stable=True)
            cat_s, cat_i = cat_s.gather(1, order), cat_i.gather(1, order)
            order = torch.argsort(cat_s, dim=1, descending=True, stable=True)[:, :k]
            best_s, best_i = cat_s.gather(1, order), cat_i.gather(1, order)
    return best_s, best_i, own
