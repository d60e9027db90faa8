"""From-scratch CLIP byte-pair-encoding tokenizer (PyTorch port's copy).

Same ids as ``clip_lora_match_tpu/tokenizer/bpe.py``'s pure-Python merge
loop. A word's merges run in the C++ core (``tokenizer/native_bpe.py``) when
its library builds, and in the Python loop otherwise; the special tokens the
Python path seeds are answered before the C++ core, which knows none, so both
give the same ids. No torch/HF.

Behavioral contract (validated by golden tests against HF ``CLIPTokenizer``
loaded from the same vocab/merges files):

- text cleaning = control-char strip, CJK spacing, NFC normalize, whitespace
  collapse, lowercase (the canonical CLIP cleanup);
- word splitting with CLIP's regex pattern
  ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|letters+|digit|other+``;
- byte-level encoding via the GPT-2 printable-byte alphabet;
- greedy lowest-rank BPE merges with the ``</w>`` end-of-word marker;
- sequences wrapped as ``<|startoftext|> ... <|endoftext|>`` and padded to a
  fixed ``max_length`` (default 77) with the EOT token, mirroring the
  reference's always-pad-to-77 policy (ref:src/preprocessing/clip_preprocess.py:51-57).

When the real 49,152-entry vocab is unavailable (zero-egress environments), a
deterministic byte-level fallback vocabulary keeps the whole stack runnable
end-to-end; drop ``vocab.json``/``merges.txt`` next to the config to get the
real subword segmentation.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Iterable, Optional, Sequence

import numpy as np
import regex as re

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

# CLIP's word-split pattern (requires the `regex` module for \p classes).
_WORD_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    re.IGNORECASE,
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte → printable-unicode-char alphabet.

    Printable ASCII and two latin-1 ranges map to themselves; the remaining
    bytes map to consecutive codepoints starting at 256 so no byte becomes
    whitespace or a control character.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in keep}
    n = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + n)
            n += 1
    return mapping


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False  # treated as whitespace
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def clean_text(text: str) -> str:
    """Canonical CLIP text cleanup: strip control chars, space out CJK,
    NFC-normalize, collapse whitespace, lowercase."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif ch.isspace():
            out.append(" ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def _adjacent_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def build_fallback_vocab_and_merges() -> tuple[dict[str, int], list[tuple[str, str]]]:
    """Deterministic byte-level vocabulary for vocab-file-less operation.

    Layout mirrors the real CLIP vocab's structure: 256 byte units, then the
    same 256 with ``</w>``, then specials — so id assignment is stable and the
    SOT/EOT ids are the two largest, preserving the argmax-EOT pooling trick.
    """
    alphabet = [bytes_to_unicode()[b] for b in range(256)]
    vocab: dict[str, int] = {}
    for ch in alphabet:
        vocab[ch] = len(vocab)
    for ch in alphabet:
        vocab[ch + "</w>"] = len(vocab)
    vocab[SOT_TOKEN] = len(vocab)
    vocab[EOT_TOKEN] = len(vocab)
    return vocab, []


class ClipTokenizer:
    """CLIP BPE tokenizer with fixed-length batch encoding.

    Parameters
    ----------
    vocab: token string → id.
    merges: ordered BPE merge pairs (rank = list position).
    max_length: pad/truncate length, CLIP context size 77.
    """

    def __init__(
        self,
        vocab: dict[str, int],
        merges: Sequence[tuple[str, str]],
        max_length: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.sot_id = self.encoder[SOT_TOKEN]
        self.eot_id = self.encoder[EOT_TOKEN]
        self.pad_id = self.eot_id  # CLIP pads with <|endoftext|>
        self.unk_id = self.eot_id
        self._cache: dict[str, str] = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self._id_cache: dict[str, list[int]] = {}
        self._merges_ranked = [tuple(m) for m in merges]
        self._native = None  # the C++ merge core, built at the first word
        self._native_tried = False

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_files(
        cls, vocab_file: str, merges_file: str, max_length: int = 77
    ) -> "ClipTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # First line of a merges.txt is a version header; merge count is
        # bounded by vocab layout (49152 - 256 - 2 specials for real CLIP).
        merge_lines = lines[1:] if lines and lines[0].startswith("#") else lines
        merges = [tuple(l.split()) for l in merge_lines if l and len(l.split()) == 2]
        return cls(vocab, merges, max_length=max_length)

    @classmethod
    def from_dir(cls, path: Optional[str], max_length: int = 77) -> "ClipTokenizer":
        """Load vocab.json + merges.txt from `path`; fall back to the
        deterministic byte-level vocab when absent."""
        if path:
            v, m = os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
            if os.path.exists(v) and os.path.exists(m):
                return cls.from_files(v, m, max_length=max_length)
        vocab, merges = build_fallback_vocab_and_merges()
        return cls(vocab, merges, max_length=max_length)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # -- BPE core ------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        """Apply greedy lowest-rank merges to one byte-alphabet word; returns
        space-joined subword units, last unit carrying ``</w>``."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = word[0]
            return word[0]
        pairs = _adjacent_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def tokenize(self, text: str) -> list[str]:
        """Text → BPE token strings (no specials)."""
        tokens: list[str] = []
        for word in _WORD_PATTERN.findall(clean_text(text)):
            byte_word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            tokens.extend(self._bpe(byte_word).split(" "))
        return tokens

    def _get_native(self):
        if not self._native_tried:
            self._native_tried = True
            from clip_lora_match_tpu_torch.tokenizer.native_bpe import NativeBPE, native_bpe_available

            if native_bpe_available():
                self._native = NativeBPE(self.encoder, self._merges_ranked, self.unk_id)
        return self._native

    def _word_ids(self, byte_word: str) -> list[int]:
        """Byte-alphabet word → ids: the Python path's cache first (it holds
        the special tokens), then the C++ merge core when built, else the
        Python merge loop."""
        cached = self._id_cache.get(byte_word)
        if cached is not None:
            return cached
        ids = None
        if byte_word not in self._cache:
            native = self._get_native()
            ids = native.encode_word(byte_word) if native is not None else None
        if ids is None:
            ids = [
                self.encoder.get(t, self.unk_id)
                for t in self._bpe(byte_word).split(" ")
            ]
        self._id_cache[byte_word] = ids
        return ids

    def encode(self, text: str, add_specials: bool = True) -> list[int]:
        ids: list[int] = []
        for word in _WORD_PATTERN.findall(clean_text(text)):
            byte_word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self._word_ids(byte_word))
        if add_specials:
            return [self.sot_id] + ids + [self.eot_id]
        return ids

    def decode(self, ids: Iterable[int], skip_specials: bool = True) -> str:
        toks = []
        for i in ids:
            tok = self.decoder.get(int(i), "")
            if skip_specials and tok in (SOT_TOKEN, EOT_TOKEN):
                continue
            toks.append(tok)
        text = "".join(toks)
        data = bytes(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -- batch encoding -------------------------------------------------------

    def __call__(
        self,
        texts: str | Sequence[str],
        max_length: Optional[int] = None,
        pad_to_max: bool = True,
        truncate: bool = True,
    ) -> dict[str, np.ndarray]:
        """Batch encode → ``{"input_ids": (B, L) int32, "attention_mask": (B, L) int32}``.

        Always pads to ``max_length`` by default (fixed batch shapes, same
        policy as ref:src/preprocessing/clip_preprocess.py:51-57).
        Truncation keeps SOT ... EOT framing (EOT forced at the final slot).
        """
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        seqs = []
        for t in texts:
            ids = self.encode(t)
            if truncate and len(ids) > L:
                ids = ids[: L - 1] + [self.eot_id]
            seqs.append(ids)
        if not pad_to_max:
            L = max(len(s) for s in seqs) if seqs else 0
        input_ids = np.full((len(seqs), L), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(seqs), L), dtype=np.int32)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}

    # -- interop --------------------------------------------------------------

    def save(self, path: str) -> None:
        """Write vocab.json + merges.txt (HF CLIPTokenizer-compatible)."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        inv = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in inv:
                f.write(f"{a} {b}\n")
