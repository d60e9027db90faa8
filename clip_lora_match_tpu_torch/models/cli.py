"""Smoke tests of the encoder (``scripts/test_clip_load.py`` and
``scripts/test_lora_inference.py``):

    python -m clip_lora_match_tpu_torch.models.cli load            # build, encode one text
    python -m clip_lora_match_tpu_torch.models.cli lora-inference  # rank true captions, merge parity

``load`` builds the encoder, encodes one text and prints the arch, the
embedding's dim and norm and the vocabulary size. ``lora-inference`` ranks
each sampled image's true caption among distractors, then folds the adapter
into the weights (``ClipEncoder.merge_lora``) and asserts that the merged
text embedding keeps a cosine above 0.9999 with the unmerged one. The flags
are the scripts' (the encoder's from ``scripts/_common.py``) plus
``--device`` (``cuda`` by default, ``cpu`` for the plain path); the
sampling seed of ``lora-inference`` is ``--sample-seed``, since ``--seed``
is the encoder's. ``run(argv)`` returns what the subcommand computed.
"""

from __future__ import annotations

import argparse
import random

import numpy as np

from clip_lora_match_tpu_torch.eval.cli import _encoder_args, build_encoder


def load(args) -> dict:
    encoder = build_encoder(args)
    emb = encoder.encode_text("smoke test kalimat pendek")
    out = dict(patch_size=encoder.arch.patch_size, dim=int(emb.shape[0]), norm=float(np.linalg.norm(emb)),
               vocab=encoder.preprocessor.tokenizer.vocab_size)
    print(f"[test_clip_load] ok: arch=ViT-B/{out['patch_size']} dim={out['dim']} "
          f"norm={out['norm']:.4f} vocab={out['vocab']}")
    return out


def lora_inference(args) -> dict:
    from clip_lora_match_tpu_torch.eval import load_eval_csv

    encoder = build_encoder(args)
    data = load_eval_csv(args.csv, require_images=True)
    if not data.texts:
        print("[test_lora_inference] no rows with images; nothing to test")
        return {}
    rng = random.Random(args.sample_seed)
    n = min(args.samples, len(data.texts))
    picks = rng.sample(range(len(data.texts)), n)
    hits, ranks = 0, []
    for i in picks:
        others = [j for j in range(len(data.texts)) if j != i]
        distractors = rng.sample(others, min(args.distractors, len(others)))
        candidates = [data.texts[i]] + [data.texts[j] for j in distractors]
        img = encoder.encode_image(data.image_paths[i])
        txt = encoder.encode_text(candidates)
        sims = txt @ img
        order = np.argsort(-sims)
        rank = int(np.where(order == 0)[0][0]) + 1
        hits += rank == 1
        ranks.append(rank)
        print(f"  sample {i}: true caption rank {rank}/{len(candidates)}")
        for r, j in enumerate(order[:3], 1):
            print(f"    {r}. [{sims[j]:.4f}] {candidates[j][:60]}")
    print(f"[test_lora_inference] top-1 {hits}/{n}")
    out = dict(picks=picks, ranks=ranks, hits=hits, cosine=None)
    if encoder.lora is not None:
        base = encoder.encode_text("merged-vs-unmerged parity probe")
        encoder.merge_lora()
        merged = encoder.encode_text("merged-vs-unmerged parity probe")
        out["cosine"] = float(base @ merged)
        print(f"[test_lora_inference] merged-vs-unmerged cosine: {out['cosine']:.6f}")
        assert out["cosine"] > 0.9999, "merge changed the embedding!"
    return out


def run(argv=None):
    p = argparse.ArgumentParser(description="Encoder smoke tests (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("load", help="build the encoder and encode one text (scripts/test_clip_load.py)")
    _encoder_args(s)
    s.set_defaults(fn=load)
    s = sub.add_parser("lora-inference", help="true-caption ranks and merged-vs-unmerged parity "
                                              "(scripts/test_lora_inference.py)")
    s.add_argument("--csv", default="data/text/val_fashion.csv")
    s.add_argument("--samples", type=int, default=3)
    s.add_argument("--distractors", type=int, default=4)
    s.add_argument("--sample-seed", type=int, default=42,
                   help="the sampling seed (the script's --seed, which collides with the encoder's)")
    _encoder_args(s)
    s.set_defaults(fn=lora_inference)
    args = p.parse_args(argv)
    return args.fn(args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
