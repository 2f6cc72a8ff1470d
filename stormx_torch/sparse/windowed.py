"""Sliced-ELLPACK with per-row-block column windows (counterpart of
``stormx/sparse/windowed.py``).

After a bandwidth-reducing reorder every nonzero of a mesh operator lies in
a narrow band, so the columns of block b (rows ``R·b .. R·b+R−1``) fall in
the uniform-stride window ``x_pad[R·b : R·b + C]``, ``x_pad`` being x
left-padded by ``pad_lo`` zeros.  The port stores ``data`` and
``local_cols`` as ``(nb, K, R)`` (the JAX package's ``(nb, R, K)``
transposed once at build time), so that neighbouring rows sit at
neighbouring addresses for the CUDA kernel.

Modes:

* ``"cuda"``: kernel K1 (:mod:`stormx_torch.ops.sell_spmv`); float32 on the
  card.  On CPU tensors its wrapper takes the plain version.
* ``"dense"``: per-block dense ``(R, C)`` windows, one batched einsum.
* ``"onehot"``: O(nnz) storage.  The JAX package selects each slot's value
  with a compare/select/sum over the whole window; the port gathers it
  directly (the plain version of K1), which gives the same sums because the
  selection adds only zeros.  The ``(nb, R, K, C)`` intermediate is never
  materialised.

:func:`auto_operator` keeps the JAX policy (DIA at ≤ ``max_diags`` offsets,
else SlicedELL, falling back dense → onehot → ELL) but keys the mode on the
target device instead of the JAX backend: CUDA with float32 gives
``"cuda"``, anything else ``"dense"``.  The target device is the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from stormx_torch.sparse.formats import CSR, device_of, host

__all__ = ["SlicedELL", "sell_from_csr", "sell_from_ell", "auto_operator"]

# Row-block height of the kernel mode.  The kernel reads x directly, so R
# only sets the row padding and the (nb, K, R) layout: 128 keeps each slot's
# read of a warp-sized row run contiguous and the tail padding under 128
# rows.  (The TPU's R=512 balanced its grid-step overhead.)
KERNEL_BLOCK_ROWS = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class SlicedELL:
    """Row-blocked ELL with uniform-stride column windows."""

    data: torch.Tensor  # (nb, K, R)
    local_cols: torch.Tensor  # (nb, K, R) int32 in [0, C); padding → 0 w/ data 0
    shape: tuple[int, int]
    window: int  # C (a multiple of R)
    pad_lo: int  # left zero-padding of x (covers the lower bandwidth)
    mode: str  # "cuda" | "dense" | "onehot"
    dense_blocks: torch.Tensor | None  # (nb, R, C), mode="dense" only

    @property
    def block_rows(self) -> int:
        return self.data.shape[2]

    def _windows(self, x: torch.Tensor) -> torch.Tensor:
        """(nb, C) windows win[b] = x_pad[R·b : R·b + C]."""
        nb, _, R = self.data.shape
        C = self.window
        total = (nb + C // R) * R
        x_pad = torch.nn.functional.pad(x, (self.pad_lo, total - self.pad_lo - x.shape[0]))
        xt = x_pad.reshape(-1, R)
        return torch.cat([xt[j : j + nb] for j in range(C // R)], dim=1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from stormx_torch.ops.sell_spmv import sell_spmv, sell_spmv_plain

        if self.mode == "cuda":
            return sell_spmv(self, x)
        if self.mode == "onehot":
            return sell_spmv_plain(self, x)
        win = self._windows(x).to(self.dense_blocks.dtype)
        y = torch.einsum("brc,bc->br", self.dense_blocks, win)
        return y.reshape(-1)[: self.shape[0]]

    def __matmul__(self, x):
        return self.matvec(x)


def sell_from_ell(ell, *, block_rows: int = 128, mode: str = "dense",
                  max_dense_bytes: int = 2**31, device=None) -> SlicedELL:
    """Build from an ELL operator whose rows are already well ordered.

    Raises ``ValueError`` when the window would cover the whole vector, or
    when dense blocks would exceed ``max_dense_bytes``; ``auto_operator``
    catches this and falls back.  ``device`` defaults to the ELL's.
    """
    return _build(host(ell.data), host(ell.cols), ell.shape, block_rows, mode,
                  device=device or device_of(ell.data), max_dense_bytes=max_dense_bytes)


def _build(data, cols, shape, R, mode, *, device, max_dense_bytes: int = 2**31):
    n, K = data.shape
    nb = -(-n // R)
    pad = nb * R - n
    if pad:
        data = np.concatenate([data, np.zeros((pad, K), data.dtype)])
        cols = np.concatenate([cols, np.zeros((pad, K), cols.dtype)])
    db = data.reshape(nb, R, K)
    cb = cols.reshape(nb, R, K)
    live = db != 0
    rows = np.broadcast_to(np.arange(nb * R).reshape(nb, R, 1), cb.shape)
    d = cb.astype(np.int64) - rows
    b_lo = int(max(-(d[live].min() if live.any() else 0), 0))
    b_hi = int(max(d[live].max() if live.any() else 0, 0))
    pad_lo = b_lo
    C = _round_up(pad_lo + R + b_hi, math.lcm(R, 128))
    if C >= shape[0] + R and shape[0] > math.lcm(R, 128):
        raise ValueError(
            f"SlicedELL window C={C} covers the whole vector (n={shape[0]}, "
            f"bandwidth {max(b_lo, b_hi)}); use the ELL gather path"
        )
    if mode == "dense" and nb * R * C * data.dtype.itemsize > max_dense_bytes:
        raise ValueError(
            f"SlicedELL dense blocks would need {nb * R * C * data.dtype.itemsize}"
            f" bytes (> max_dense_bytes={max_dense_bytes}); band too wide after"
            " reordering — use mode='onehot' or the ELL gather path"
        )
    base = (np.arange(nb) * R - pad_lo)[:, None, None]
    local = np.where(live, cb - base, 0).astype(np.int64)
    if live.any() and not (local[live].min() >= 0 and local[live].max() < C):
        raise AssertionError("SlicedELL window does not cover a live column")
    dense = None
    if mode == "dense":
        dense = np.zeros((nb, R, C), dtype=data.dtype)
        b_idx = np.repeat(np.arange(nb), R * K)
        r_idx = np.tile(np.repeat(np.arange(R), K), nb)
        np.add.at(dense, (b_idx, r_idx, local.reshape(-1)), db.reshape(-1))
    dev = torch.device(device)
    return SlicedELL(
        data=torch.as_tensor(np.ascontiguousarray(db.transpose(0, 2, 1)), device=dev),
        local_cols=torch.as_tensor(
            np.ascontiguousarray(local.astype(np.int32).transpose(0, 2, 1)), device=dev
        ),
        shape=shape,
        window=C,
        pad_lo=pad_lo,
        mode=mode,
        dense_blocks=None if dense is None else torch.as_tensor(dense, device=dev),
    )


def _permuted_csr(csr, perm):
    """Host CSR of ``csr`` with rows and columns renumbered by ``perm``
    (``perm[new] = old``), columns sorted within each row."""
    n = csr.shape[0]
    row_ptr, indices, data = host(csr.row_ptr), host(csr.indices), host(csr.data)
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    new_rows, new_cols = inv[rows], inv[indices]
    order = np.lexsort((new_cols, new_rows))
    rp = np.zeros(n + 1, dtype=np.int32)
    np.add.at(rp, new_rows + 1, 1)
    return CSR(
        data=data[order],
        indices=new_cols[order].astype(np.int32),
        row_ptr=np.cumsum(rp).astype(np.int32),
        shape=csr.shape,
    ), len(np.unique(new_cols - new_rows))


def _order(csr, reorder: bool, coords):
    n = csr.shape[0]
    if not reorder:
        return np.arange(n, dtype=np.int64)
    from stormx_torch.parallel.partition import bandwidth_order

    rows = np.repeat(np.arange(n), np.diff(host(csr.row_ptr)))
    return bandwidth_order(n, rows, host(csr.indices).astype(np.int64), coords)


def sell_from_csr(csr, *, block_rows: int = 128, mode: str = "dense",
                  reorder: bool = True, coords=None, device=None):
    """CSR → (SlicedELL, perm): bandwidth-minimizing reorder (RCM, or the best
    of RCM and coordinate sorts when ``coords`` are given), then slice into
    row blocks.  ``perm[new] = old``; solve in permuted space
    (``b_p = b[perm]``) and map back with ``x = x_p[inv]``.  ``device``
    defaults to the CSR's.
    """
    from stormx_torch.sparse.formats import ell_from_csr

    device = device or device_of(csr.data)
    perm = _order(csr, reorder, coords)
    if reorder:
        csr, _ = _permuted_csr(csr, perm)
    ell = ell_from_csr(csr, device=False)
    return _build(ell.data, ell.cols, csr.shape, block_rows, mode, device=device), perm


def _to_device(op, device):
    fields = {
        f.name: getattr(op, f.name).to(device)
        for f in dataclasses.fields(op)
        if isinstance(getattr(op, f.name), torch.Tensor)
    }
    return dataclasses.replace(op, **fields)


def auto_operator(csr, *, reorder: bool = True, max_diags: int = 64,
                  block_rows: int | None = None, mode: str = "auto", coords=None,
                  device="cuda"):
    """Pick the fast path for a sparse operator → (operator, perm).

    Reorder, then DIA iff ≤ ``max_diags`` distinct offsets survive, else
    SlicedELL.  ``mode="auto"`` resolves to the CUDA kernel for float32
    operators on a CUDA ``device`` and to the dense-window einsum elsewhere.
    When dense windows would be too large the operator falls back to
    ``"onehot"``, and when even the windows span the whole vector, to the
    plain ELL gather.  The operator lives on ``device``, the card by default
    whatever the CSR's device (the JAX package follows its default backend);
    with no card this raises unless the caller passes ``device="cpu"``.
    """
    from stormx_torch.core.config import resolve_device
    from stormx_torch.sparse.formats import dia_from_csr, ell_from_csr

    device = resolve_device(device)
    perm = _order(csr, reorder, coords)
    pcsr, n_offsets = _permuted_csr(csr, perm)
    if n_offsets <= max_diags:
        return _to_device(dia_from_csr(pcsr, max_diags=max_diags), device), perm
    if mode == "auto":
        cuda_f32 = device.type == "cuda" and pcsr.data.dtype == np.float32
        mode = "cuda" if cuda_f32 else "dense"
    if block_rows is None:
        block_rows = KERNEL_BLOCK_ROWS
    try:
        sell, _ = sell_from_csr(pcsr, block_rows=block_rows, mode=mode,
                                reorder=False, device=device)
        return sell, perm
    except ValueError:
        pass
    if mode == "dense":
        try:
            sell, _ = sell_from_csr(pcsr, block_rows=block_rows, mode="onehot",
                                    reorder=False, device=device)
            return sell, perm
        except ValueError:
            pass
    return _to_device(ell_from_csr(pcsr), device), perm
