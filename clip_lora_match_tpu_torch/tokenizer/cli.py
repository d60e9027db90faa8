"""Learn a BPE merge table from a caption corpus and write ``vocab.json`` and
``merges.txt`` (``scripts/learn_bpe.py``):

    python -m clip_lora_match_tpu_torch.tokenizer.cli --merges 1200 --out build/fashion_bpe

``--out`` is required: the script's default, ``tests/fixtures/fashion_bpe``,
is a committed fixture that a run over the in-repo CSV would overwrite with a
far smaller table. The default corpus is the in-repo ``data/text/val_fashion.csv``; the script's
default, the reference checkout's 4,441-caption val CSV, is not part of the
repository, so pass it with ``--csv`` where it exists. ``run(argv)`` returns
(vocab, merges).
"""

from __future__ import annotations

import argparse
import csv


def run(argv=None):
    ap = argparse.ArgumentParser(description="Learn a BPE merge table from a caption CSV (PyTorch port)")
    ap.add_argument("--csv", default="data/text/val_fashion.csv",
                    help="caption CSV with a 'text' column (default: the in-repo val rows; the "
                         "script's default, the reference's 4,441-caption val CSV, is not in the repo)")
    ap.add_argument("--merges", type=int, default=1200)
    ap.add_argument("--out", required=True,
                    help="directory for vocab.json and merges.txt (no default: the script's, "
                         "tests/fixtures/fashion_bpe, is a committed fixture)")
    args = ap.parse_args(argv)

    from clip_lora_match_tpu_torch.tokenizer.learn import learn_bpe, save_bpe

    with open(args.csv, newline="", encoding="utf-8") as f:
        texts = [row["text"] for row in csv.DictReader(f)]
    print(f"[learn_bpe] {len(texts)} captions from {args.csv}")
    vocab, merges = learn_bpe(texts, num_merges=args.merges)
    save_bpe(vocab, merges, args.out)
    print(f"[learn_bpe] learned {len(merges)} merges, vocab {len(vocab)} -> {args.out}")
    return vocab, merges


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
