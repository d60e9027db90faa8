"""Deterministic seeding (port of ``utils/seeding.py``; the reference seeds
random, numpy and torch, ref:scripts/train_lora.py:22-26)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed python's, numpy's and torch's global generators, and return a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the port's
    counterpart of the JAX package's root PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
