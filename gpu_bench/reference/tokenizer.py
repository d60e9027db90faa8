"""Frozen plain copy of the CLIP byte-pair tokenizer the port serves with.

CLIP's cleanup (control characters out, CJK spaced, NFC, whitespace
collapsed, lower case), CLIP's word pattern, the GPT-2 byte alphabet, greedy
lowest-rank merges with ``</w>``, ``<|startoftext|> ... <|endoftext|>``
framing, truncation that keeps the end token, and padding to 77 with the end
token. Without vocabulary files the port serves the deterministic byte-level
vocabulary (256 bytes, the same with ``</w>``, then the two specials), which
``ByteTokenizer()`` builds. Imports nothing of the port.
"""

from __future__ import annotations

import unicodedata

import numpy as np
import regex as re

SOT, EOT = "<|startoftext|>", "<|endoftext|>"
_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    re.IGNORECASE,
)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def byte_alphabet() -> dict[int, str]:
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


def clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in (0, 0xFFFD) or (ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")):
            continue
        if any(lo <= cp <= hi for lo, hi in _CJK):
            out.append(f" {ch} ")
        elif ch.isspace():
            out.append(" ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(w.lower() for w in text.split())


class ByteTokenizer:
    def __init__(self, vocab: dict[str, int] | None = None, merges=(), length: int = 77):
        self.alphabet = byte_alphabet()
        if vocab is None:
            units = [self.alphabet[b] for b in range(256)]
            vocab = {u: i for i, u in enumerate(units)}
            vocab.update({u + "</w>": 256 + i for i, u in enumerate(units)})
            vocab[SOT], vocab[EOT] = 512, 513
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.length = length
        self.sot, self.eot = vocab[SOT], vocab[EOT]

    def _merge(self, word: str) -> list[str]:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return parts

    def ids(self, text: str) -> list[int]:
        out = [self.sot]
        for word in _PATTERN.findall(clean(text)):
            if word in (SOT, EOT):
                out.append(self.vocab[word])
                continue
            units = "".join(self.alphabet[b] for b in word.encode("utf-8"))
            out.extend(self.vocab.get(u, self.eot) for u in self._merge(units))
        out.append(self.eot)
        if len(out) > self.length:
            out = out[: self.length - 1] + [self.eot]
        return out

    def __call__(self, texts) -> np.ndarray:
        """(B, 77) int64 ids padded with the end token."""
        rows = np.full((len(texts), self.length), self.eot, np.int64)
        for i, t in enumerate(texts):
            ids = self.ids(t)
            rows[i, : len(ids)] = ids
        return rows
