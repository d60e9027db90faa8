"""Device resolution for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``). Asking for CUDA on a
host without it raises instead of quietly running on the CPU; callers that
want the CPU (the parity tests) say ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
