"""Two measurement probes, each a CUDA kernel with a plain version
(counterparts of ``scripts/pallas_gather_probe.py`` and
``scripts/perf_pallas_bisect.py``).

* P1, :func:`lane_gather`: ``y[m, l] = x[m, idx[m, l]]`` on (rows, width)
  float32 with int32 indices, the in-chunk gather that the packed SlicedELL
  (K4) rests on.  Its plain version is ``torch.gather(x, 1, idx)``; they agree
  bit for bit.
* P2, :func:`dia_stream_probe`: the four modes that split the banded SpMV's
  (K2a's) bandwidth by stream, on ``diag`` (5, n) and ``x`` (n + 2048,):
  ``"full"`` z[i] = c + Σ_d diag[d, i]·x[i + 128·d], ``"diag"`` z[i] =
  c + Σ_d diag[d, i], ``"win"`` z[i] = 2·x[i + 1024] + c, ``"zonly"``
  z[i] = 1.5 + c.  The kernel rounds each product and sum in the plain
  version's order, so they agree bit for bit too.

Both launch their kernel (``csrc/probes.cu``) for tensors on the card and
take the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from stormx_torch.ops.dia import _blocks  # K2a's grid

__all__ = [
    "lane_gather",
    "lane_gather_plain",
    "lane_gather_cuda",
    "dia_stream_probe",
    "dia_stream_probe_plain",
    "dia_stream_probe_cuda",
    "STREAM_MODES",
    "stream_bytes",
]

STREAM_MODES = ("full", "diag", "win", "zonly")
N_DIAGS = 5
X_HALO = 16 * 128  # x holds n + 2048 floats: the probe's 16 extra rows of 128 lanes
# Kernel launches of this process, by probe; only the *_cuda functions add to them.
launches = {"lane_gather": 0, "dia_stream_probe": 0}


def stream_bytes(mode: str, n: int) -> int:
    """Bytes a mode must move at n rows (float32): the diagonals it reads,
    the n floats of x it reads, and z."""
    reads = {"full": N_DIAGS + 1, "diag": N_DIAGS, "win": 1, "zonly": 0}[mode]
    return 4 * (reads + 1) * n


# -- P1 ----------------------------------------------------------------------


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P1."""
    return torch.gather(x, 1, idx.long())


def lane_gather_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch P1; raises on what it does not take.  An index outside
    [0, width) gives 0."""
    from stormx_torch.ops import _cuda

    if not (x.is_cuda and idx.is_cuda and x.device == idx.device):
        raise ValueError("lane_gather_cuda needs x and idx on one CUDA device")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("lane_gather takes float32 x and int32 idx")
    if x.dim() != 2 or idx.shape != x.shape or not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous (rows, width) tensors of one shape")
    y = torch.empty_like(x)
    lib = _cuda.library("probes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_lane_gather(x.data_ptr(), idx.data_ptr(), y.data_ptr(), x.numel(),
                                    x.shape[1], stream)
    _cuda.check(lib, rc, "lane_gather")
    launches["lane_gather"] += 1
    return y


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y[m, l] = x[m, idx[m, l]]: P1 on the card, the plain version on the CPU."""
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return lane_gather_plain(x, idx)
    return lane_gather_cuda(x, idx)


# -- P2 ----------------------------------------------------------------------


def _check_mode(mode: str) -> None:
    if mode not in STREAM_MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {STREAM_MODES}")


def dia_stream_probe_plain(mode: str, c: float, x: torch.Tensor,
                           diag: torch.Tensor) -> torch.Tensor:
    """Plain version of P2."""
    _check_mode(mode)
    n = diag.shape[1]
    acc = torch.full((n,), c, dtype=torch.float32, device=diag.device)
    if mode == "full":
        for d in range(N_DIAGS):
            acc = acc + diag[d] * x[128 * d : 128 * d + n]
        return acc
    if mode == "diag":
        for d in range(N_DIAGS):
            acc = acc + diag[d]
        return acc
    if mode == "win":
        return x[1024 : 1024 + n] * 2.0 + acc
    return torch.full_like(acc, 1.5) + acc


def dia_stream_probe_cuda(mode: str, c: float, x: torch.Tensor,
                          diag: torch.Tensor) -> torch.Tensor:
    """Launch P2 on K2a's grid; raises on what it does not take."""
    from stormx_torch.ops import _cuda

    _check_mode(mode)
    if not (x.is_cuda and diag.is_cuda and x.device == diag.device):
        raise ValueError("dia_stream_probe_cuda needs x and diag on one CUDA device")
    if x.dtype != torch.float32 or diag.dtype != torch.float32:
        raise ValueError("dia_stream_probe takes float32 x and diag")
    if diag.dim() != 2 or diag.shape[0] != N_DIAGS or not diag.is_contiguous():
        raise ValueError(f"diag must be a contiguous ({N_DIAGS}, n) tensor")
    n = diag.shape[1]
    if x.shape != (n + X_HALO,) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous ({n + X_HALO},) tensor, got {tuple(x.shape)}")
    z = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _cuda.library("probes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_dia_stream_probe(diag.data_ptr(), x.data_ptr(), z.data_ptr(), n,
                                         float(c), STREAM_MODES.index(mode),
                                         _blocks(n, x.device), stream)
    _cuda.check(lib, rc, f"dia_stream_probe ({mode})")
    launches["dia_stream_probe"] += 1
    return z


def dia_stream_probe(mode: str, c: float, x: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """P2 in ``mode`` on the card, the plain version on the CPU."""
    if x.device.type == "cpu" and diag.device.type == "cpu":
        return dia_stream_probe_plain(mode, c, x, diag)
    return dia_stream_probe_cuda(mode, c, x, diag)
