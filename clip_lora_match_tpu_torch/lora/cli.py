"""Export or merge LoRA adapters (``scripts/export_lora.py``):

    python -m clip_lora_match_tpu_torch.lora.cli merge  --adapter DIR --out merged.npz --weights base.npz
    python -m clip_lora_match_tpu_torch.lora.cli peft   --adapter DIR --out peft_dir
    python -m clip_lora_match_tpu_torch.lora.cli native --adapter DIR --out native_dir

``merge`` folds the adapter (native or PEFT) into the base weights and writes
the merged ``.npz``; ``peft`` and ``native`` rewrite the adapter in the other
format. As in the script, the written config is ``LoraConfig(r=8,
alpha=round(8 * scaling))``, whatever the adapter's rank. The flags are the
script's (the encoder's from ``scripts/_common.py``) plus ``--device``
(``cuda`` by default, ``cpu`` for the plain path). ``run(argv)`` returns the
merged tree or the adapter tree written.
"""

from __future__ import annotations

import argparse

from clip_lora_match_tpu_torch.eval.cli import _encoder_args, build_encoder


def run(argv=None):
    p = argparse.ArgumentParser(description="Export / merge LoRA adapters (PyTorch)")
    p.add_argument("mode", choices=["merge", "peft", "native"])
    p.add_argument("--adapter", required=True, help="adapter dir (native or PEFT)")
    p.add_argument("--out", required=True)
    _encoder_args(p)
    args = p.parse_args(argv)

    from clip_lora_match_tpu_torch.core.config import LoraConfig
    from clip_lora_match_tpu_torch.lora.adapter import load_lora, merge_lora, save_lora
    from clip_lora_match_tpu_torch.lora.peft_io import save_peft_adapter
    from clip_lora_match_tpu_torch.models.io import save_params

    if args.mode == "merge":
        encoder = build_encoder(args)
        lora, scaling = load_lora(args.adapter, device=encoder.device, arch=encoder.arch)
        merged = merge_lora(encoder.params, lora, scaling)
        save_params(args.out, merged)
        print(f"[export_lora] merged weights -> {args.out}")
        return merged
    lora, scaling = load_lora(args.adapter, device=args.device)
    cfg = LoraConfig(r=8, alpha=int(round(8 * scaling)))
    (save_peft_adapter if args.mode == "peft" else save_lora)(args.out, lora, cfg)
    print(f"[export_lora] {args.mode} adapter -> {args.out}")
    return lora


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
