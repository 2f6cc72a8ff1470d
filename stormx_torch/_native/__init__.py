"""Native host-runtime loader (the port's own copy of ``stormx/_native``).

Compiles ``hostrt.cpp`` with g++ on first use (cached as ``hostrt.so`` next
to the source, rebuilt when the source is newer) and exposes it through
ctypes.  The caller keeps a pure-NumPy fallback with identical output, so a
missing toolchain degrades to the slower path rather than failing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["load_hostrt", "native_rcm_order"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hostrt.cpp")
_LIB = os.path.join(_DIR, "hostrt.so")

_lib = None
_load_failed = False


def _build() -> None:
    # Build to a private name and rename: test workers may build at once.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
         "-o", tmp, _SRC],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, _LIB)


def load_hostrt():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)
    except (OSError, subprocess.CalledProcessError):
        _load_failed = True
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.stormx_rcm_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.stormx_rcm_order.restype = ctypes.c_int
    _lib = lib
    return _lib


def _as_i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_rcm_order(row_ptr: np.ndarray, cols: np.ndarray) -> np.ndarray | None:
    """RCM ordering from CSR adjacency; None if the native lib is unavailable."""
    lib = load_hostrt()
    if lib is None:
        return None
    n = len(row_ptr) - 1
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    rc = lib.stormx_rcm_order(n, _as_i64_ptr(row_ptr), _as_i64_ptr(cols), _as_i64_ptr(out))
    return out if rc == 0 else None
