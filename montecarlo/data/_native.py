"""ctypes bridge to the native CSV loader (montecarlo/native/).

Compiles the C++ on first use (g++ -O3 -shared, cached by source hash) and
falls back to None when no toolchain is available — callers then use the
pandas/Python path.  pybind11 isn't in the image; the C ABI + ctypes is the
binding layer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, Optional

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "csv_loader.cc")
_CACHE_DIR = os.environ.get("MCTPU_NATIVE_CACHE",
                            os.path.join(tempfile.gettempdir(),
                                         "mctpu_native"))

_lib = None
_lib_failed = False


def _build() -> Optional[str]:
    with open(_SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_CACHE_DIR, f"csv_loader_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SOURCE, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded shared library, or None when unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    path = _build()
    if path is None:
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # Stale/foreign cached .so (other arch, missing runtime libs):
        # fall back to pandas permanently instead of raising on every call.
        _lib_failed = True
        return None
    pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))
    lib.mctpu_load_ohlcv.restype = ctypes.c_long
    lib.mctpu_load_ohlcv.argtypes = [ctypes.c_char_p, pp, pp, pp, pp, pp]
    lib.mctpu_free.restype = None
    lib.mctpu_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def load_ohlcv_csv(path: str) -> Optional[Dict[str, np.ndarray]]:
    """OHLCV dict from a CSV via the native loader; None if unavailable or
    the file is malformed (caller falls back to pandas)."""
    lib = get_lib()
    if lib is None:
        return None
    ptrs = [ctypes.POINTER(ctypes.c_double)() for _ in range(5)]
    n = lib.mctpu_load_ohlcv(path.encode(), *[ctypes.byref(p) for p in ptrs])
    if n < 0:
        return None
    names = ("Open", "High", "Low", "Close", "Volume")
    out = {}
    for name, ptr in zip(names, ptrs):
        # Copy into numpy-owned memory, then free the C buffer.
        out[name] = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        lib.mctpu_free(ptr)
    return out
