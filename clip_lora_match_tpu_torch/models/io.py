"""Weight bridge: flat ``.npz`` parameter files ↔ torch trees.

The file format is the JAX package's (``clip_lora_match_tpu/models/io.py``):
one array per leaf under a ``"/"``-joined key, the stacked leading layer axis
and the ``(in, out)`` kernel layout kept; a list's items sit under numbered
keys. ``params_from_numpy`` turns such a flat dict into the port's nested
dict of tensors, unchanged in layout, and ``save_params`` writes one; the same
holds for LoRA trees (``{"a": (L, in, r), "b": (L, r, out)}`` per
projection). Either package reads the other's files.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

Params = dict[str, Any]
_SEP = "/"


def params_from_numpy(
    flat: dict[str, np.ndarray],
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = torch.float32,
) -> Params:
    """Flat ``{"a/b/c": array}`` → nested dict of tensors on ``device``.
    Floating leaves take ``dtype`` (None keeps theirs); integer leaves keep
    their type."""
    from clip_lora_match_tpu_torch.core.device import resolve_device

    return to_device(unflatten(flat), resolve_device(device), dtype)


def flatten_params(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts and lists of tensors → flat ``{"a/b/c": array}`` on the
    host (list items under numbered keys)."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_params(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_params(v, f"{prefix}{i}{_SEP}"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        flat[prefix.rstrip(_SEP)] = np.asarray(tree)
    return flat


def unflatten(flat: dict) -> Params:
    """Flat ``{"a/b/c": leaf}`` → nested dicts, the leaves as they are."""
    tree: Params = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[("a/b/c", leaf)] of nested dicts in sorted key order and lists in
    order (the JAX package's leaf order), the leaves as they are; for a tree
    of dicts alone ``unflatten(dict(...))`` rebuilds it."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves(tree[k], f"{prefix}{k}{_SEP}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_leaves(v, f"{prefix}{i}{_SEP}")]
    return [(prefix.rstrip(_SEP), tree)]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of nested dicts and lists; with more trees
    of the same structure, ``fn`` takes their leaves at the same place."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def to_device(tree, device, dtype: torch.dtype | None = None):
    """Nested dicts and lists of numpy arrays or tensors → tensors on ``device``
    (floating leaves cast to ``dtype`` when given)."""

    def conv(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(conv, tree)


def save_params(path: str, params) -> None:
    """Write a tree as the flat ``.npz`` both packages' ``load_params`` read."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flatten_params(params))


def load_params(
    path: str, device: str | torch.device = "cuda", dtype: torch.dtype | None = torch.float32
) -> Params:
    """Load a flat ``.npz`` written by either package."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, device=device, dtype=dtype)
