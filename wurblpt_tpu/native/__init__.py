"""Native (C++) host-side components.

The reference keeps its latency-sensitive host steps — BVH build, OBJ parse —
in optimized C++ (``libwurblpt/bvh.hpp``, ``tiny_obj_loader.h``). This package
does the same here: small C++ shared libraries compiled
on first use with the local toolchain and called through ctypes (no pybind11
in this environment). Every native component has a pure-numpy fallback so the
framework still works where no C++ toolchain exists.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_lock = threading.Lock()
_libs = {}


def _compile(name: str, sources) -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    srcs = [os.path.join(_SRC_DIR, s) for s in sources]
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(out) and os.path.getmtime(out) >= newest_src:
        return out
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fno-exceptions", "-o", out, *srcs,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return out


def load_library(name: str, sources) -> ctypes.CDLL:
    """Compile (if stale) and dlopen a native component; raises on failure."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_compile(name, sources))
        return _libs[name]


def try_load_library(name: str, sources):
    """Like load_library but returns None when the toolchain is unavailable."""
    try:
        return load_library(name, sources)
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return None
