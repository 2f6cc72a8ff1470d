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

__all__ = ["load_hostrt", "native_rcm_order", "native_bfs_partition", "native_ilu0",
           "native_ic0"]

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
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.stormx_rcm_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.stormx_rcm_order.restype = ctypes.c_int
    lib.stormx_bfs_partition.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p]
    lib.stormx_bfs_partition.restype = ctypes.c_int
    lib.stormx_ilu0.argtypes = [ctypes.c_int64, i64p, i64p, f64p]
    lib.stormx_ilu0.restype = ctypes.c_int
    lib.stormx_ic0.argtypes = [ctypes.c_int64, i64p, i64p, f64p]
    lib.stormx_ic0.restype = ctypes.c_int
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


def native_bfs_partition(row_ptr: np.ndarray, cols: np.ndarray, k: int) -> np.ndarray | None:
    """Balanced BFS k-way partition labels; None if the native lib is
    unavailable."""
    lib = load_hostrt()
    if lib is None:
        return None
    n = len(row_ptr) - 1
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    rc = lib.stormx_bfs_partition(n, _as_i64_ptr(row_ptr), _as_i64_ptr(cols), k,
                                  _as_i64_ptr(out))
    return out if rc == 0 else None


def _as_f64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def native_ilu0(row_ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> np.ndarray | None:
    """ILU(0) factor values on A's CSR pattern; None if the native lib is
    unavailable.  Raises on a missing diagonal or a zero pivot (the Python
    implementation's exceptions)."""
    lib = load_hostrt()
    if lib is None:
        return None
    n = len(row_ptr) - 1
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    lu = np.array(vals, dtype=np.float64, copy=True, order="C")
    rc = lib.stormx_ilu0(n, _as_i64_ptr(row_ptr), _as_i64_ptr(cols), _as_f64_ptr(lu))
    if rc == 1:
        raise ValueError("ILU(0) needs an explicitly stored diagonal")
    if rc == 2:
        raise ZeroDivisionError("zero pivot in ILU(0)")
    return lu


def native_ic0(l_ptr: np.ndarray, l_cols: np.ndarray, l_vals: np.ndarray) -> np.ndarray | None:
    """IC(0) factor values on lower(A)'s CSR pattern (ascending columns,
    diagonal last per row); None if the native lib is unavailable."""
    lib = load_hostrt()
    if lib is None:
        return None
    n = len(l_ptr) - 1
    l_ptr = np.ascontiguousarray(l_ptr, dtype=np.int64)
    l_cols = np.ascontiguousarray(l_cols, dtype=np.int64)
    out = np.array(l_vals, dtype=np.float64, copy=True, order="C")
    rc = lib.stormx_ic0(n, _as_i64_ptr(l_ptr), _as_i64_ptr(l_cols), _as_f64_ptr(out))
    if rc == 1:
        raise ValueError("IC(0) needs an explicitly stored diagonal")
    if rc < 0:
        raise ValueError(
            f"IC(0) breakdown at row {-rc - 1}: non-positive pivot "
            "(matrix not (nearly) SPD, or pattern too sparse)"
        )
    return out
