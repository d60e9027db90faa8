"""ctypes bridge to the C++ JPEG loader ``native/clm_native.cpp`` (port of
``clip_lora_match_tpu/data/native_loader.py``).

Decode → resize → center-crop (→ normalize) of JPEG batches runs in native
threads (libjpeg and PIL's cubic resampling written out). Rows the library
cannot take (not a JPEG, corrupt, or no library) are redone through the PIL
pipeline, so a caller always gets the whole batch: the JAX package's
semantics for such a file. The PIL rows run on up to ``num_threads`` threads
(PIL releases the GIL while it decodes and resamples), so a host without
libjpeg's headers, where every row is a PIL row, still decodes in parallel;
the rows are the same as one at a time, and the first failing row (in
order) raises. The library builds at first use into ``build/torch_native/``
(``core/native.py``).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from clip_lora_match_tpu_torch.core import native
from clip_lora_match_tpu_torch.core.config import PreprocessConfig
from clip_lora_match_tpu_torch.core.logging import get_logger

log = get_logger("native")

_U8P = ctypes.POINTER(ctypes.c_ubyte)
_F32P = ctypes.POINTER(ctypes.c_float)
_lib: Optional[ctypes.CDLL] = None
_failed = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed, ABI ``clm_native_version() >=
    3``: the trailing DCT-scale argument); None when it cannot be built."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        lib = native.load("clm_native")
        if lib.clm_native_version() < 3:
            raise RuntimeError(f"clm_native ABI {lib.clm_native_version()} < 3")
    except (OSError, RuntimeError) as e:
        log.warning("native loader unavailable: %s", e)
        _failed = True
        return None
    lib.clm_preprocess_batch.restype = ctypes.c_int
    lib.clm_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        _F32P, _F32P, _F32P, ctypes.c_int, _U8P, ctypes.c_int,
    ]
    lib.clm_preprocess_batch_u8.restype = ctypes.c_int
    lib.clm_preprocess_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        _U8P, ctypes.c_int, _U8P, ctypes.c_int,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _dct_scale_default() -> bool:
    """DCT-domain scaled decode (libjpeg's N/8 scales: decode at the smallest
    scale that still covers the target's short side, then cubic to size).
    Off unless ``CLM_NATIVE_DCT_SCALE`` says otherwise, as in the JAX
    package: its lowpass differs slightly from a full decode, so strict PIL
    pixel parity is the default and ``ClipEncoder.encode_image_files`` opts
    in."""
    return os.environ.get("CLM_NATIVE_DCT_SCALE", "0") not in ("0", "false")


def _threads(num_threads: Optional[int]) -> int:
    return num_threads or max(1, os.cpu_count() or 1)


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _pil_rows(out: np.ndarray, ok: np.ndarray, paths: Sequence[str], row_fn: Callable,
              cfg: PreprocessConfig, num_threads: Optional[int]) -> None:
    """Fill the rows the library did not (``ok == 0``) through ``row_fn``
    (a PIL pipeline), on up to ``num_threads`` threads."""
    rows = np.flatnonzero(ok == 0)
    threads = min(_threads(num_threads), len(rows))
    if threads <= 1:
        for i in rows:
            out[i] = row_fn(paths[i], cfg)
        return
    with ThreadPoolExecutor(threads, thread_name_prefix="pil_rows") as pool:
        for i, row in zip(rows, pool.map(lambda i: row_fn(paths[i], cfg), rows)):
            out[i] = row


def preprocess_image_batch_native(
    paths: Sequence[str],
    cfg: Optional[PreprocessConfig] = None,
    num_threads: Optional[int] = None,
    dct_scale: Optional[bool] = None,
) -> np.ndarray:
    """paths → (N, S, S, 3) float32, CLIP-normalized; failed rows through PIL."""
    cfg = cfg or PreprocessConfig()
    if dct_scale is None:
        dct_scale = _dct_scale_default()
    n, size = len(paths), cfg.image_size
    out = np.empty((n, size, size, 3), np.float32)
    if n == 0:
        return out
    lib = get_lib()
    ok = np.zeros(n, np.uint8)
    if lib is not None:
        mean = np.asarray(cfg.mean, np.float32)
        std = np.asarray(cfg.std, np.float32)
        lib.clm_preprocess_batch(
            _c_paths(paths), n, size, mean.ctypes.data_as(_F32P), std.ctypes.data_as(_F32P),
            out.ctypes.data_as(_F32P), _threads(num_threads), ok.ctypes.data_as(_U8P),
            int(dct_scale),
        )
    if not ok.all():
        from clip_lora_match_tpu_torch.preprocess.image import preprocess_image

        _pil_rows(out, ok, paths, preprocess_image, cfg, num_threads)
    return out


def preprocess_image_batch_native_u8(
    paths: Sequence[str],
    cfg: Optional[PreprocessConfig] = None,
    num_threads: Optional[int] = None,
    dct_scale: Optional[bool] = None,
) -> np.ndarray:
    """paths → (N, S, S, 3) uint8 RGB, resized and center-cropped but not
    normalized (a quarter of the fp32 batch's bytes to move to the device);
    failed rows through PIL."""
    cfg = cfg or PreprocessConfig()
    if dct_scale is None:
        dct_scale = _dct_scale_default()
    n, size = len(paths), cfg.image_size
    out = np.empty((n, size, size, 3), np.uint8)
    if n == 0:
        return out
    lib = get_lib()
    ok = np.zeros(n, np.uint8)
    if lib is not None:
        lib.clm_preprocess_batch_u8(
            _c_paths(paths), n, size, out.ctypes.data_as(_U8P), _threads(num_threads),
            ok.ctypes.data_as(_U8P), int(dct_scale),
        )
    if not ok.all():
        from clip_lora_match_tpu_torch.preprocess.image import load_resized_cropped_u8

        _pil_rows(out, ok, paths, load_resized_cropped_u8, cfg, num_threads)
    return out
