"""Native (C++) host components, built lazily with the system toolchain.

The reference's host-side native pieces (METIS partitioning; part.cpp) are
re-provided here as small C++ shared libraries bound through ctypes — no
pybind11/pip requirements.  Build artifacts are cached under
``build/saamge_tpu_torch/native/`` of the checkout, never next to the
sources, and keyed by a source-content hash (a stale or foreign-arch
binary — built with -march=native elsewhere — is never loaded).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                      "saamge_tpu_torch", "native")
_LOCK = threading.Lock()
_LIBS = {}


def _build(name: str) -> str:
    src = os.path.join(_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"lib{name}_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
           "-o", tmp, src]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load libname.so; returns None if the toolchain
    is unavailable so callers can fall back to pure Python."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(_build(name))
        except Exception:
            lib = None
        _LIBS[name] = lib
        return lib
