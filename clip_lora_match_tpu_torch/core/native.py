"""Build and load the two host libraries of ``native/``: the JPEG loader
(``clm_native.cpp``, libjpeg and a thread pool) and the BPE merge core
(``clm_bpe.cpp``).

Each is compiled at first use with ``g++ -O3 -fPIC -shared -std=c++17`` (the
loader linked with ``-ljpeg -lpthread``, as ``native/Makefile`` does) into
``build/torch_native/<name>-<hash>.so`` at the root of the checkout. The hash
covers the source and the flags, so an edit rebuilds. Each build writes a
file of its own and renames it into place, so processes that build at once
never load a half-written library. Nothing is written into ``native/``, and
nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LINK = {"clm_native": ("-ljpeg", "-lpthread"), "clm_bpe": ()}

_LOCK = threading.Lock()


def target(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds to under the current flags."""
    src = (NATIVE_DIR / f"{name}.cpp").read_bytes()
    flags = " ".join(CXX_FLAGS + LINK[name]).encode()
    return BUILD_DIR / f"{name}-{hashlib.sha256(src + flags).hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its build is there; raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    out = target(name)
    with _LOCK:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{name}.cpp"), *LINK[name]]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:  # no g++
            raise RuntimeError(f"g++ failed for {name}.cpp: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stderr}")
        os.replace(tmp, out)
        return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, building it if needed."""
    return ctypes.CDLL(str(build(name)))
