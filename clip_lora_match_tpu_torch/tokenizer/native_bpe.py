"""ctypes bridge to the C++ BPE merge core ``native/clm_bpe.cpp`` (port of
``clip_lora_match_tpu/tokenizer/native_bpe.py``).

Text cleaning and word splitting stay in Python; only the greedy merge loop
of one byte-alphabet word runs in C++. The library builds at first use into
``build/torch_native/`` (``core/native.py``). The C++ core knows no special
tokens: ``ClipTokenizer._word_ids`` answers those from the Python path's
cache before it calls ``encode_word``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from clip_lora_match_tpu_torch.core import native
from clip_lora_match_tpu_torch.core.logging import get_logger

log = get_logger("native_bpe")

_I32P = ctypes.POINTER(ctypes.c_int32)
_STRP = ctypes.POINTER(ctypes.c_char_p)
_lib = None
_failed = False


def _get_lib():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        lib = native.load("clm_bpe")
        if lib.clm_bpe_version() < 1:
            raise RuntimeError(f"clm_bpe ABI {lib.clm_bpe_version()} < 1")
    except (OSError, RuntimeError) as e:
        log.info("native BPE unavailable (%s); using the Python merges", e)
        _failed = True
        return None
    lib.clm_bpe_init.restype = ctypes.c_void_p
    lib.clm_bpe_init.argtypes = [
        _STRP, _I32P, _I32P, ctypes.c_int32, _STRP, _I32P, _STRP, _I32P,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.clm_bpe_free.restype = None
    lib.clm_bpe_free.argtypes = [ctypes.c_void_p]
    lib.clm_bpe_encode_word.restype = ctypes.c_int32
    lib.clm_bpe_encode_word.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, _I32P, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def native_bpe_available() -> bool:
    return _get_lib() is not None


def _strings(items: list[bytes]):
    return (ctypes.c_char_p * len(items))(*items), (ctypes.c_int32 * len(items))(*map(len, items))


class NativeBPE:
    """A native model handle for one (vocab, ranked merges) table."""

    def __init__(self, vocab: dict[str, int], merges_ranked: list[tuple[str, str]], unk_id: int):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native BPE library unavailable")
        self._lib = lib
        toks = list(vocab.items())
        c_tokens, c_tlens = _strings([t.encode() for t, _ in toks])
        c_tids = (ctypes.c_int32 * len(toks))(*[i for _, i in toks])
        c_a, c_al = _strings([a.encode() for a, _ in merges_ranked])
        c_b, c_bl = _strings([b.encode() for _, b in merges_ranked])
        self._handle = lib.clm_bpe_init(
            c_tokens, c_tlens, c_tids, len(toks), c_a, c_al, c_b, c_bl, len(merges_ranked), unk_id,
        )
        self._out = (ctypes.c_int32 * 512)()
        # one output buffer per model: concurrent calls take turns on it
        self._out_lock = threading.Lock()

    def encode_word(self, byte_word: str) -> Optional[list[int]]:
        """Byte-alphabet word → token ids, or None when they overflow the
        buffer. Thread-safe."""
        data = byte_word.encode()
        with self._out_lock:
            n = self._lib.clm_bpe_encode_word(self._handle, data, len(data), self._out, len(self._out))
            return None if n < 0 else list(self._out[:n])

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.clm_bpe_free(handle)
