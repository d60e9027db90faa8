"""The general generator of every traffic mix: arrival schedules, query and
caption texts, pixels and index rows, each drawn from the run's seed.

Every seed gets the same set of sizes and arrivals in another order: the
gaps between arrivals are the quantiles of one exponential distribution and
the token lengths one fixed multiset, both permuted by the seed. So two
seeds give the same work, and a run's numbers move with the system, not with
the draw.
"""

from __future__ import annotations

import numpy as np

from gpu_bench.harness import seeds


def arrival_offsets(n: int, rate: float, seconds: float, seed: int) -> np.ndarray:
    """``n`` arrival times in [0, seconds) of an open loop at ``rate`` per
    second: Poisson gaps, as the ``n`` quantiles of Exp(rate) permuted by the
    seed, scaled so that the last arrival is due half a gap before the
    window's end."""
    if n <= 0:
        return np.zeros((0,), np.float64)
    p = (np.arange(n, dtype=np.float64) + 0.5) / n
    gaps = -np.log1p(-p) / rate
    gaps = seeds.rng(seed, "arrivals").permutation(gaps)
    offsets = np.cumsum(gaps)
    return offsets * (seconds * (n - 0.5) / n / offsets[-1])


def token_lengths(n: int, lo: int, hi: int, seed: int, tag: str = "lengths") -> np.ndarray:
    """``n`` token lengths: lo..hi cycled, permuted by the seed."""
    base = lo + np.arange(n) % (hi - lo + 1)
    return seeds.rng(seed, tag).permutation(base)


def byte_tokens(text: str) -> int:
    """Tokens of an ASCII text under the byte-level vocabulary the port
    serves with: one a non-space byte, plus the start and end tokens."""
    return sum(1 for c in text if not c.isspace()) + 2


def _sentence(words: dict, r: np.random.Generator) -> str:
    pick = lambda key: words[key][r.integers(len(words[key]))]  # noqa: E731
    form = r.integers(4)
    if form == 0:
        return f"{pick('items')} {pick('colors')} {pick('details')}, ditemukan di {pick('places')}."
    if form == 1:
        return f"hilang {pick('items')} warna {pick('colors')} di {pick('places')}"
    if form == 2:
        return f"{pick('fashion_items')} {pick('colors')} untuk {pick('genders')}, category {pick('categories')}"
    return f"{pick('items')} {pick('colors')} {pick('details')}"


def text_of_length(words: dict, tokens: int, r: np.random.Generator) -> str:
    """A lower-case text of exactly ``tokens`` byte-level tokens: sentences
    of the word lists joined until long enough, cut at the last byte that
    fits."""
    need = tokens - 2
    text = _sentence(words, r)
    while byte_tokens(text) - 2 < need:
        text += " " + _sentence(words, r)
    out, count = [], 0
    for c in text:
        if count == need:
            break
        out.append(c)
        count += not c.isspace()
    return "".join(out).strip()


def texts(words: dict, lengths: np.ndarray, seed: int, tag: str) -> list[str]:
    r = seeds.rng(seed, tag)
    return [text_of_length(words, int(n), r) for n in lengths]


def unit_rows(n: int, d: int, seed: int, device, block: int = 1 << 18, tag: str = "rows"):
    """Yields (start, rows) blocks of ``n`` seeded unit rows (fp32, on
    ``device``), each block from its own generator: the same rows for the
    same seed, made again block by block by the reference."""
    import torch

    for start in range(0, n, block):
        m = min(block, n - start)
        g = seeds.device_generator(seed, device, tag, start)
        x = torch.randn((m, d), generator=g, device=device, dtype=torch.float32)
        yield start, torch.nn.functional.normalize(x, dim=1)


def pixels_u8(n: int, size: int, seed: int, device, tag: str):
    """(n, size, size, 3) seeded uint8 pixels on ``device``."""
    import torch

    g = seeds.device_generator(seed, device, tag)
    return torch.randint(0, 256, (n, size, size, 3), generator=g, device=device, dtype=torch.uint8)


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(u8):
    """uint8 pixels → CLIP-normalized fp32, as the image preprocessor gives
    them to the encoder."""
    import torch

    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=u8.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=u8.device)
    return (u8.float() / 255.0 - mean) / std
