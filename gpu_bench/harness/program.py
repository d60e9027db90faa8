"""The program under test as every driver builds it: the port's encoder
from a configuration file and the seeded weights, and the reference's copy
of the same weights."""

from __future__ import annotations

import time

from gpu_bench.harness import weights


def arch_and_config(cfg: dict):
    """The port's ``ClipArchConfig`` and ``ClipConfig`` for a configuration
    file: its preset by ``model.name``, which has to hold the file's widths."""
    import dataclasses

    from clip_lora_match_tpu_torch.core.config import ARCH_PRESETS, ClipArchConfig, ClipConfig

    w = cfg["widths"]
    arch = ClipArchConfig(**w)
    preset = ARCH_PRESETS.get(cfg["model_name"])
    if preset is not None and dataclasses.asdict(preset) != dataclasses.asdict(arch):
        raise ValueError(f"{cfg['name']}: the widths differ from the port's preset {cfg['model_name']}")
    conf = ClipConfig(model_name=cfg["model_name"], arch=arch, compute_dtype=cfg["serving_compute_dtype"])
    return arch, conf


def build_kernels(device) -> float:
    """Build every kernel of the port at once (cached in ``build/`` inside
    the checkout after the first run); seconds taken."""
    if getattr(device, "type", str(device)) != "cuda":
        return 0.0
    from clip_lora_match_tpu_torch.ops import _build

    t = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t


def encoder(ctx, quantize: str | None = None):
    """The port's ``ClipEncoder`` over the seeded weights and adapter."""
    from clip_lora_match_tpu_torch.models.encoder import ClipEncoder

    cfg = ctx.config
    arch, conf = arch_and_config(cfg)
    params = weights.clip_weights(cfg["widths"], ctx.seed, ctx.device)
    lora = weights.lora_weights(cfg["widths"], cfg["lora"], ctx.seed, ctx.device)
    scaling = cfg["lora"]["alpha"] / cfg["lora"]["r"]
    return ClipEncoder(params, arch=arch, config=conf, lora=lora, lora_scaling=scaling,
                       quantize=quantize, device=ctx.device)


def seeded_weights(ctx):
    """(CLIP weights, LoRA adapter, LoRA scaling) drawn from the run's seed:
    the same tensors each call, for the program and again for the reference."""
    cfg = ctx.config
    return (weights.clip_weights(cfg["widths"], ctx.seed, ctx.device),
            weights.lora_weights(cfg["widths"], cfg["lora"], ctx.seed, ctx.device),
            cfg["lora"]["alpha"] / cfg["lora"]["r"])


def free_device(device) -> None:
    import gc

    import torch

    gc.collect()
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
