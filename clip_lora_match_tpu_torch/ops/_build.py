"""Build and load the hand-written CUDA kernels in ``ops/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout (the hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edit rebuilds) and loaded with
``ctypes``. ``build_all`` starts one ``nvcc`` per source at once, so the
build costs the slowest file, not their sum. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = (
    "attention_small", "lora_matmul", "retrieval_topk", "retrieval_tilemax",
    "mlp_fused", "flash_attention", "retrieval_binmax",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    # the hash covers the headers too: an edit to a shared .cuh rebuilds its users
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    h = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every named source in parallel; returns nvcc's log per source
    (register and shared-memory use from ``-Xptxas -v``), empty when cached."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name))
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return _LIBS[name]


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu`` with its argument types set once (and an
    int result), so a call passes plain Python ints and floats and builds no
    ctypes objects."""
    key = f"{name}:{symbol}"
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    return _sm_count(device.index if device.index is not None else 0)


def stream_ptr(tensor) -> int:
    """The current CUDA stream of ``tensor``'s device as an int."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # the same stream, without building a Stream object
        return raw(tensor.device.index if tensor.device.index is not None else torch.cuda.current_device())
    return torch.cuda.current_stream(tensor.device).cuda_stream
