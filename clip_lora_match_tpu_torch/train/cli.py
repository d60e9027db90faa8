"""Contrastive LoRA fine-tune of CLIP on the card (the port's counterpart of
``scripts/train_lora.py``, ref:scripts/train_lora.py:111-249).

    python -m clip_lora_match_tpu_torch.train.cli --config config/lora_config.yaml
    python -m clip_lora_match_tpu_torch.train.cli --arch tiny --device cpu --max-steps-per-epoch 5

The arguments are ``scripts/train_lora.py``'s (``--config``,
``--max-steps-per-epoch``, ``--chain-steps``, ``--arch vit-b32|tiny``,
``--weights``) plus ``--device`` (``cuda`` by default). A second run with
the same config resumes from the last checkpoint (``training.resume``,
true by default). ``--chain-steps`` is read and has no effect (see
``TrainingConfig``). Without ``--weights`` the base weights are random
from the training seed. ``run`` returns the ``TrainResult``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

DEFAULT_LORA_CONFIG = "config/lora_config.yaml"
# a miniature tower for runs on the CPU (scripts/train_lora.py's "tiny")
TINY_ARCH = dict(
    image_size=64, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4,
    vision_mlp_dim=128, vocab_size=600, max_text_length=32, text_width=64, text_layers=2,
    text_heads=4, text_mlp_dim=128, projection_dim=32,
)


def run(argv=None):
    p = argparse.ArgumentParser(description="Contrastive LoRA fine-tune of CLIP (PyTorch)")
    p.add_argument("--config", default=DEFAULT_LORA_CONFIG)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--chain-steps", type=int, default=None,
                   help="read for the JAX package's interface; no effect (the same trajectory)")
    p.add_argument("--arch", choices=["vit-b32", "tiny"], default="vit-b32",
                   help="'tiny' trains a miniature tower (runs on the CPU)")
    p.add_argument("--weights", default=None, help="base CLIP weights (.npz)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from clip_lora_match_tpu_torch.core.config import ClipArchConfig, load_lora_config
    from clip_lora_match_tpu_torch.train import train

    config = args.config if os.path.exists(args.config) else None
    lora_cfg, train_cfg = load_lora_config(config)
    if args.chain_steps is not None:
        train_cfg = dataclasses.replace(train_cfg, chain_steps=args.chain_steps)
    arch = ClipArchConfig(**TINY_ARCH) if args.arch == "tiny" else None
    result = train(
        lora_cfg=lora_cfg, train_cfg=train_cfg, arch=arch, weights_path=args.weights,
        max_steps_per_epoch=args.max_steps_per_epoch, device=args.device,
    )
    final = result.train_losses[-1] if result.train_losses else float("nan")
    print(f"[train] done: {result.epochs} epochs, {result.steps} steps, final loss {final:.4f}, "
          f"adapters in {result.output_dir}", flush=True)
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
