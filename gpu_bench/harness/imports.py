"""The check that the measured process loaded no JAX.

Names are compared whole, by the part of each module name before its first
dot: ``clip_lora_match_tpu_torch`` (the port) begins with
``clip_lora_match_tpu`` (the JAX package) and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "clip_lora_match_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)
