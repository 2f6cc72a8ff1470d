"""K1: the SlicedELL SpMV ``y = A·x`` (counterpart of
``stormx/ops/pallas_sell.py``).

:func:`sell_spmv` launches the CUDA kernel ``csrc/sell_spmv.cu`` for tensors
on the card and takes the plain PyTorch version :func:`sell_spmv_plain` only
for tensors on the CPU.  The kernel wants float32, like the TPU kernel, and
no row-block restriction.  The K-sum order differs between the two (the
kernel accumulates k = 0..K−1 with FMAs), so they agree to float32 roundoff,
not bit for bit.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["sell_spmv", "sell_spmv_plain", "sell_spmv_cuda", "supports_kernel"]

launches = 0  # kernel launches of this process; only sell_spmv_cuda adds to it
_count_lock = threading.Lock()  # ranks that share a card are threads of one process


def supports_kernel(sell) -> bool:
    """The kernel takes float32 operators."""
    return sell.data.dtype == torch.float32


def sell_spmv_plain(sell, x: torch.Tensor) -> torch.Tensor:
    """Plain version: an O(nnz) gather over each block's window,
    ``y[R·b + r] = Σ_k data[b,k,r] · x_pad[R·b + local_cols[b,k,r]]`` with
    ``x_pad`` = x left-padded by ``pad_lo`` zeros."""
    nb, K, R = sell.data.shape
    x = x.to(sell.data.dtype)
    n = x.shape[0]
    x_pad = torch.nn.functional.pad(x, (sell.pad_lo, nb * R + sell.window - sell.pad_lo - n))
    base = torch.arange(nb, device=x.device).mul_(R)[:, None, None]
    gathered = x_pad[base + sell.local_cols]  # (nb, K, R)
    y = torch.sum(sell.data * gathered, dim=1)  # (nb, R)
    return y.reshape(-1)[: sell.shape[0]]


def sell_spmv_cuda(sell, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raises on what it does not take."""
    global launches
    from stormx_torch.ops import _cuda

    data, cols = sell.data, sell.local_cols
    n_rows, n_cols = sell.shape
    if not (x.is_cuda and data.is_cuda and cols.is_cuda):
        raise ValueError("sell_spmv_cuda needs CUDA tensors")
    if x.device != data.device or cols.device != data.device:
        raise ValueError("operator and x lie on different devices")
    if data.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("the SlicedELL kernel takes float32 data and x")
    if cols.dtype != torch.int32 or cols.shape != data.shape or data.dim() != 3:
        raise ValueError("local_cols must be int32 of data's (nb, K, R) shape")
    if x.shape != (n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({n_cols},)")
    if not (x.is_contiguous() and data.is_contiguous() and cols.is_contiguous()):
        raise ValueError("sell_spmv_cuda needs contiguous tensors")
    nb, K, R = data.shape
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lib = _cuda.library("sell_spmv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_sell_spmv(data.data_ptr(), cols.data_ptr(), x.data_ptr(),
                                  y.data_ptr(), n_rows, n_cols, R, K, sell.pad_lo, stream)
    _cuda.check(lib, rc, "sell_spmv")
    with _count_lock:
        launches += 1
    return y


def sell_spmv(sell, x: torch.Tensor) -> torch.Tensor:
    """y = A·x: the kernel for tensors on the card, the plain version for
    tensors on the CPU."""
    if x.device.type == "cpu":
        return sell_spmv_plain(sell, x)
    return sell_spmv_cuda(sell, x)
