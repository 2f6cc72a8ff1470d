"""Build and load the hand-written CUDA kernels of ``stormx_torch/csrc``.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/stormx_torch/lib<name>.so`` at the repository root, with a plain C
interface that ``ctypes`` loads.  A library is rebuilt when its source, or
a header ``csrc/*.cuh``, is newer, so a fresh checkout builds everything on
first use.  Every C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

__all__ = ["SOURCES", "build", "library", "check", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "stormx_torch")

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# source name -> {C entry: its argument types}; every entry returns an int.
# A source may carry several entries, one per kernel it launches.
ENTRIES = {
    "sell_spmv": {"stormx_sell_spmv": [_P, _P, _P, _P, _I64, _I64, _I, _I, _I, _P]},
    "banded_gather": {
        "stormx_banded_gather": [_P, _P, _P, _P, _I64, _I, _I, _I, _P],
        "stormx_empty_launch": [_I, _P],
    },
    "dia_spmv": {"stormx_dia_spmv": [_P, _P, _P, _P, _P, _I64, _I64, _I, _P, _I, _I, _P]},
    "cg_update": {
        "stormx_cg_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    },
    "sell_packed": {
        "stormx_packed_spmv_matmul": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P],
        "stormx_packed_spmv_gather": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                      _I, _I, _I, _I, _I, _P],
        "stormx_smem_optin": [_I],
        "stormx_packed_gather_blocks_per_sm": [_I, _I, _I],
    },
    "probes": {
        "stormx_lane_gather": [_P, _P, _P, _I64, _I, _P],
        "stormx_dia_stream_probe": [_P, _P, _P, _I64, _F, _I, _I, _P],
    },
}
SOURCES = tuple(ENTRIES)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name -> nvcc's output (ptxas register/spill report)


def _src(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def _lib_path(name: str) -> str:
    return os.path.join(_BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in [_src(name), *headers])


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build(names=SOURCES) -> float:
    """Compile every stale source among ``names``, one ``nvcc`` each, all
    started together.  Returns the wall seconds spent; raises on failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _src(name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        lib.stormx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.stormx_cuda_error_string.restype = ctypes.c_char_p
        for entry, argtypes in ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.stormx_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
