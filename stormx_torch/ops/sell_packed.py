"""K4: the chunk-packed SlicedELL SpMV ``y = A·x`` (counterpart of
``stormx/ops/pallas_sell2.py``).

:func:`pack_sell` repacks a float32 :class:`~stormx_torch.sparse.windowed.SlicedELL`
into (nb, M, 128) tiles with the JAX package's host packer (:func:`_pack`,
a copy, bit-exact): every tile row holds entries of one 128-wide chunk of the
block's x window, and every entry stays in the lane of its matrix row.  An
index word is ``owner << 12 | chunk << 7 | lane``: the entry multiplies
``x[b·R − pad_lo + chunk·128 + lane]`` and belongs to row
``b·R + owner·128 + l``.  Two variants compute the same product:

* K4a, ``"matmul"``: sums every live slot into its owner's row
  (``csrc/sell_packed.cu`` ``packed_matmul_kernel``), reading no tile row at
  or past ``rows_used[b]`` (1 + the last tile row of block b that holds a
  non-zero value) and no index word or x value of a zero-valued slot;
* K4b, ``"gather"``: sums each row's K entries in ELL order through the
  source map ``src`` (``packed_gather_kernel``).

:meth:`PackedSELL.matvec` goes through one ``torch.autograd.Function``:
its forward launches the variant's kernel for tensors on the card and takes
the plain version :func:`packed_spmv_plain` only for tensors on the CPU; its
``jvp`` is the same SpMV of the tangent (the operator is linear), so
``torch.func.jvp`` differentiates through it.  There is no transpose kernel,
as the JAX package has none, so ``backward`` raises.  The kernels and the
plain version add in other orders, so they agree to float32 roundoff.  K4a
and its plain version skip the zero-valued slots that the JAX kernel
multiplies, so they differ from it only where x holds Inf or NaN at such a
slot's address (0·Inf is NaN there).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "PackedSELL",
    "pack_sell",
    "supports_packed",
    "packed_spmv",
    "packed_spmv_plain",
    "packed_spmv_cuda",
    "rows_used_of",
]

VARIANTS = ("matmul", "gather")
LANES = 128
# Kernel launches of this process, by variant; only packed_spmv_cuda adds to them.
launches = {"matmul": 0, "gather": 0}


def supports_packed(sell) -> bool:
    """The packing envelope (the JAX package's ``supports_pallas2``):
    float32 data, R a multiple of 128 and at most 2048 (owner in 4 bits),
    a window C that is a multiple of 128 and at most 4096 (chunk in 5 bits)."""
    return (
        sell.block_rows % LANES == 0
        and sell.block_rows <= 2048
        and sell.window % LANES == 0
        and sell.window <= 4096
        and sell.data.dtype == torch.float32
    )


def _pack(data: np.ndarray, local: np.ndarray):
    """(nb, R, K) ELL arrays → packed (nb, M, 128) index/value tiles and the
    source map.  A copy of ``stormx/ops/pallas_sell2.py:_pack``.

    Entry (block b, row r, slot k) with value v and window-local column
    lc lands at tile position (m, r mod 128) where m is a row allocated to
    chunk lc>>7; within each (b, chunk, lane) group entries take
    consecutive ranks, and rows-per-chunk = max over lanes of the group
    count, so no two entries collide.
    """
    nb, R, K = data.shape
    sub = R // 128
    nc = int(local.max() >> 7) + 1 if local.size else 1
    b, r, k = np.nonzero(data != 0)
    val = data[b, r, k]
    lc = local[b, r, k].astype(np.int64)
    lane = r % 128
    owner = r // 128
    c = lc >> 7
    lane2 = lc & 127
    # rank within each (b, chunk, lane) group
    key = (b * nc + c) * 128 + lane
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, np.diff(ks) != 0])
    gid = np.zeros(len(ks), dtype=np.int64)
    gid[starts] = 1
    gid = np.cumsum(gid) - 1
    rank = np.arange(len(ks)) - starts[gid]
    bc = ks >> 7  # b * nc + c
    rows_per = np.zeros(nb * nc, dtype=np.int64)
    np.maximum.at(rows_per, bc, rank + 1)
    rp2 = rows_per.reshape(nb, nc)
    off2 = np.cumsum(rp2, axis=1) - rp2  # row offset of chunk c within block
    # +1 keeps one all-zero row in every block (row M-1), the target of the
    # source map's dead entries; M ≥ nc and M ≥ sub·K as in the JAX package.
    M = max(int(rp2.sum(axis=1).max()) + 1, nc, sub * K)
    M = -(-M // 8) * 8
    m = off2.reshape(-1)[bc] + rank
    idx_arr = np.zeros((nb, M, 128), dtype=np.int32)
    vals_arr = np.zeros((nb, M, 128), dtype=data.dtype)
    bo, lo = b[order], lane[order]
    word = (owner[order].astype(np.int64) << 12) | (c[order] << 7) | lane2[order]
    idx_arr[bo, m, lo] = word.astype(np.int32)
    vals_arr[bo, m, lo] = val[order]
    # Chunk constant per tile row: padding slots carry their row's chunk.
    row_chunk = np.zeros((nb, M), dtype=np.int32)
    np.maximum.at(row_chunk, (bo, m), (c[order]).astype(np.int32))
    idx_arr = (idx_arr & ~(31 << 7)) | (row_chunk[:, :, None] << 7)
    # Row-order → packed-slot map: entry (b, r, k) sits at tile row
    # (r//128)·K + k, lane r%128; dead entries point at the zero row M-1.
    src_arr = np.full((nb, M, 128), M - 1, dtype=np.int32)
    src_arr[b, owner * K + k, lane] = m[np.argsort(order, kind="stable")]
    return idx_arr, vals_arr, src_arr


@dataclass(frozen=True)
class PackedSELL:
    """Chunk-packed SlicedELL operator; ``variant`` picks K4a ("matmul") or
    K4b ("gather")."""

    idx: torch.Tensor  # (nb, M, 128) int32 packed words
    vals: torch.Tensor  # (nb, M, 128) float32
    src: torch.Tensor  # (nb, M, 128) int32 row-order → packed tile rows
    rows_used: torch.Tensor  # (nb,) int32: 1 + the last tile row with a non-zero value
    shape: tuple[int, int]
    window: int  # C
    pad_lo: int
    block_rows: int  # R
    ell_k: int  # K (row-order slots per row)
    variant: str = "matmul"

    @property
    def sub(self) -> int:
        return self.block_rows // LANES

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _PackedSpmv.apply(self, x)

    def __matmul__(self, x):
        return self.matvec(x)


def pack_sell(sell, variant: str = "matmul") -> PackedSELL:
    """Repack a :class:`~stormx_torch.sparse.windowed.SlicedELL` for K4, on
    the SlicedELL's device.  Raises ``ValueError`` outside the envelope of
    :func:`supports_packed` or for an unknown variant."""
    if not supports_packed(sell):
        raise ValueError(
            "packed SlicedELL needs f32, block_rows % 128 == 0 (≤ 2048),"
            f" window ≤ 4096; got R={sell.block_rows}, C={sell.window},"
            f" dtype={sell.data.dtype}"
        )
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    # The port stores (nb, K, R); the packer reads the JAX package's (nb, R, K).
    data = sell.data.cpu().numpy().transpose(0, 2, 1)
    local = sell.local_cols.cpu().numpy().transpose(0, 2, 1)
    idx, vals, src = _pack(data, local)
    dev = sell.data.device
    vals = torch.as_tensor(vals, device=dev)
    return PackedSELL(
        idx=torch.as_tensor(idx, device=dev),
        vals=vals,
        src=torch.as_tensor(src, device=dev),
        rows_used=rows_used_of(vals),
        shape=tuple(sell.shape),
        window=sell.window,
        pad_lo=sell.pad_lo,
        block_rows=sell.block_rows,
        ell_k=sell.data.shape[1],
        variant=variant,
    )


def rows_used_of(vals: torch.Tensor) -> torch.Tensor:
    """(nb,) int32 on ``vals``' device: 1 + the last tile row of each block
    that holds a non-zero value (0 for a block without one)."""
    live_rows = (vals != 0).any(dim=2)
    rank = torch.arange(1, vals.shape[1] + 1, device=vals.device)
    return (live_rows * rank).amax(dim=1).to(torch.int32)


# -- plain version -----------------------------------------------------------


def _products(packed: PackedSELL, x: torch.Tensor) -> torch.Tensor:
    """vals·x at every slot, (nb, M, 128); x is read through the zero-padded
    window ``x_pad[b·R + chunk·128 + lane]``.  For "matmul" (K4a) only at
    the live slots, as its kernel reads them: non-zero values in tile rows
    below ``rows_used``; every other slot's product is 0."""
    nb, M, _ = packed.idx.shape
    R, n = packed.block_rows, x.shape[0]
    x = x.to(packed.vals.dtype)
    x_pad = torch.nn.functional.pad(x, (packed.pad_lo, nb * R + packed.window - packed.pad_lo - n))
    idx = packed.idx.long()
    base = (torch.arange(nb, device=x.device) * R)[:, None, None]
    address = base + (((idx >> 7) & 31) << 7) + (idx & 127)
    if packed.variant == "gather":
        return packed.vals * x_pad[address]
    below = torch.arange(M, device=x.device)[None, :] < packed.rows_used[:, None].to(x.device)
    live = (packed.vals != 0) & below[:, :, None]
    xv = torch.zeros_like(packed.vals)
    xv[live] = x_pad[address[live]]
    return packed.vals * xv


def packed_spmv_plain(packed: PackedSELL, x: torch.Tensor) -> torch.Tensor:
    """Plain version of either variant, in its own reduction order: "matmul"
    sums each owner's slots over the M tile rows, "gather" sums each row's
    K entries taken through the source map."""
    nb = packed.idx.shape[0]
    prod = _products(packed, x)
    sub = packed.sub
    if packed.variant == "gather":
        K = packed.ell_k
        xr = torch.gather(prod, 1, packed.src[:, : sub * K].long())
        y = xr.reshape(nb, sub, K, LANES).sum(dim=2)
    elif sub == 1:
        y = prod.sum(dim=1)
    else:
        owner = packed.idx >> 12
        y = torch.stack([torch.where(owner == s, prod, 0.0).sum(dim=1) for s in range(sub)], dim=1)
    return y.reshape(-1)[: packed.shape[0]]


# -- kernels -----------------------------------------------------------------


def packed_spmv_cuda(packed: PackedSELL, x: torch.Tensor) -> torch.Tensor:
    """Launch the variant's kernel (K4a or K4b); raises on what it does not
    take."""
    from stormx_torch.ops import _cuda

    idx, vals, src, used = packed.idx, packed.vals, packed.src, packed.rows_used
    n_rows, n_cols = packed.shape
    tensors = (idx, vals, src, used, x)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("packed_spmv_cuda needs CUDA tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("operator and x lie on different devices")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("the packed SlicedELL kernels take float32 values and x")
    if idx.dtype != torch.int32 or src.dtype != torch.int32 or used.dtype != torch.int32:
        raise ValueError("idx, src and rows_used must be int32")
    if vals.dim() != 3 or vals.shape[2] != LANES or idx.shape != vals.shape \
            or src.shape != vals.shape:
        raise ValueError("idx, vals and src must share one (nb, M, 128) shape")
    if used.shape != vals.shape[:1]:
        raise ValueError(f"rows_used has shape {tuple(used.shape)}, expected ({vals.shape[0]},)")
    if x.shape != (n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({n_cols},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("packed_spmv_cuda needs contiguous tensors")
    if packed.variant not in VARIANTS:
        raise ValueError(f"unknown variant {packed.variant!r}")
    nb, M, _ = vals.shape
    R = packed.block_rows
    if R % LANES or not 1 <= R // LANES <= 16 or n_rows > nb * R:
        raise ValueError(f"block_rows {R} and shape {packed.shape} do not fit the tiles")
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lib = _cuda.library("sell_packed")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if packed.variant == "matmul":
            if (idx.data_ptr() | vals.data_ptr()) % 16:
                raise ValueError("K4a reads idx and vals 16 bytes at a time: align them to 16")
            rc = lib.stormx_packed_spmv_matmul(
                idx.data_ptr(), vals.data_ptr(), used.data_ptr(), x.data_ptr(), y.data_ptr(),
                n_rows, n_cols, nb, M, R, packed.pad_lo, stream)
        else:
            rc = lib.stormx_packed_spmv_gather(
                idx.data_ptr(), vals.data_ptr(), src.data_ptr(), x.data_ptr(), y.data_ptr(),
                n_rows, n_cols, M, R, packed.ell_k, packed.pad_lo, stream)
    _cuda.check(lib, rc, f"packed_spmv ({packed.variant})")
    launches[packed.variant] += 1
    return y


def packed_spmv(packed: PackedSELL, x: torch.Tensor) -> torch.Tensor:
    """y = A·x: the variant's kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if x.device.type == "cpu" and packed.vals.device.type == "cpu":
        return packed_spmv_plain(packed, x)
    return packed_spmv_cuda(packed, x)


class _PackedSpmv(torch.autograd.Function):
    """y = A·x with forward-mode AD: the tangent of y is A·(tangent of x)."""

    @staticmethod
    def forward(packed, x):
        return packed_spmv(packed, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.packed = inputs[0]

    @staticmethod
    def jvp(ctx, packed_tangent, x_tangent):
        # Through apply, so that under torch.func the kernel sees a plain tensor.
        return _PackedSpmv.apply(ctx.packed, x_tangent)

    @staticmethod
    def backward(ctx, grad_y):
        raise NotImplementedError(
            "PackedSELL has no transpose kernel (Aᵀ·g), so no reverse-mode "
            "gradient; use forward mode (torch.func.jvp)"
        )
