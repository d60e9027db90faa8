"""BPE merge-table learning over a text corpus (port of ``tokenizer/learn.py``).

Learns a merge table with the CLIP conventions of ``tokenizer/bpe.py``: the
same text cleanup, word-split regex, byte alphabet and ``</w>`` end-of-word
marker, and the same vocab layout (256 byte units, their 256 ``</w>`` forms,
merged tokens in merge order, then SOT and EOT last, so the EOT id is the
largest). ``save_bpe`` writes vocab.json / merges.txt that ``ClipTokenizer``
and HF ``CLIPTokenizer`` both load.

Standard BPE over word-type frequencies with incremental pair counts: only
the words that hold the merged pair are re-segmented at each step. Ties in
pair frequency break by lexicographic pair order, so one corpus gives one
table, the JAX package's.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterable, Sequence

from clip_lora_match_tpu_torch.tokenizer.bpe import (
    EOT_TOKEN,
    SOT_TOKEN,
    _WORD_PATTERN,
    bytes_to_unicode,
    clean_text,
)


def _pretokenize_counts(texts: Iterable[str]) -> collections.Counter:
    """Corpus → byte-alphabet word-type frequencies (CLIP pre-tokenization)."""
    byte_enc = bytes_to_unicode()
    counts: collections.Counter = collections.Counter()
    for text in texts:
        for tok in _WORD_PATTERN.findall(clean_text(text)):
            counts["".join(byte_enc[b] for b in tok.encode("utf-8"))] += 1
    return counts


def learn_bpe(
    texts: Iterable[str], num_merges: int = 1024, min_pair_count: int = 2
) -> tuple[dict[str, int], list[tuple[str, str]]]:
    """Learn up to ``num_merges`` BPE merges; returns (vocab, merges)."""
    word_counts = _pretokenize_counts(texts)
    # word type → current segmentation
    segs: dict[str, tuple[str, ...]] = {
        w: tuple(w[:-1]) + (w[-1] + "</w>",) for w in word_counts
    }
    pair_counts: collections.Counter = collections.Counter()
    pair_words: dict[tuple[str, str], set[str]] = collections.defaultdict(set)
    for w, seg in segs.items():
        c = word_counts[w]
        for p in zip(seg[:-1], seg[1:]):
            pair_counts[p] += c
            pair_words[p].add(w)

    merges: list[tuple[str, str]] = []
    for _ in range(num_merges):
        if not pair_counts:
            break
        best = min(pair_counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        if pair_counts[best] < min_pair_count:
            break
        merges.append(best)
        a, b = best
        ab = a + b
        for w in list(pair_words.pop(best, ())):
            seg = segs[w]
            c = word_counts[w]
            # remove this word's contribution to every old pair
            for p in zip(seg[:-1], seg[1:]):
                pair_counts[p] -= c
                if pair_counts[p] <= 0:
                    del pair_counts[p]
                s = pair_words.get(p)
                if s is not None:
                    s.discard(w)
                    if not s:
                        pair_words.pop(p, None)
            # re-segment with the new merge applied left to right (every
            # occurrence merges in one rank step, as at tokenize time)
            new: list[str] = []
            i = 0
            while i < len(seg):
                if i < len(seg) - 1 and seg[i] == a and seg[i + 1] == b:
                    new.append(ab)
                    i += 2
                else:
                    new.append(seg[i])
                    i += 1
            seg = tuple(new)
            segs[w] = seg
            for p in zip(seg[:-1], seg[1:]):
                pair_counts[p] += c
                pair_words[p].add(w)

    # CLIP vocab layout: byte units, </w> forms, merged tokens, specials last
    alphabet = [bytes_to_unicode()[b] for b in range(256)]
    vocab: dict[str, int] = {}
    for ch in alphabet:
        vocab[ch] = len(vocab)
    for ch in alphabet:
        vocab[ch + "</w>"] = len(vocab)
    for a, b in merges:
        tok = a + b
        if tok not in vocab:
            vocab[tok] = len(vocab)
    vocab[SOT_TOKEN] = len(vocab)
    vocab[EOT_TOKEN] = len(vocab)
    return vocab, merges


def save_bpe(
    vocab: dict[str, int], merges: Sequence[tuple[str, str]], out_dir: str
) -> None:
    """Write vocab.json + merges.txt in the HF CLIPTokenizer file format."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
