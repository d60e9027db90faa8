"""Seeds derived from the run's ``--seed``: one independent stream for each
named part of a run (weights, index rows, texts, arrivals), so that adding a
part never moves another part's numbers."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for ``tags`` under ``seed`` (any whole number)."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def device_generator(seed: int, device, *tags):
    """A ``torch.Generator`` on ``device`` seeded for ``tags``."""
    import torch

    return torch.Generator(device=device).manual_seed(derive(seed, *tags))
