"""Small utilities over nested dicts (and lists) of tensors or arrays."""

from __future__ import annotations

import numpy as np


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif tree is not None:
        yield tree


def tree_size(tree) -> int:
    """Total number of elements of the leaves."""
    return sum(int(np.prod(x.shape, dtype=np.int64)) for x in _leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of the leaves (tensors or arrays)."""
    total = 0
    for x in _leaves(tree):
        itemsize = x.element_size() if hasattr(x, "element_size") else np.dtype(x.dtype).itemsize
        total += int(np.prod(x.shape, dtype=np.int64)) * itemsize
    return total
