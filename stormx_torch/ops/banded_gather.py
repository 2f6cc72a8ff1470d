"""K3: the banded gather ``y = x[idx]`` (counterpart of
``stormx/ops/pallas_gather.py``).

:class:`BandedGatherPlan` keeps the JAX package's host plan build
unchanged: per-block window starts (``starts``), window-local indices
(``lidx``, with ``C`` marking an out-of-window row), the fixup list
(``fix_pos``, ``fix_idx``) and the wide-map fallback (``xla_fallback``: a
map wider than ``MAX_CHUNKS`` windows of 128 runs as a plain gather, the
package's own policy).  A call launches the CUDA kernel
``csrc/banded_gather.cu`` for tensors on the card and takes the plain
version :func:`banded_gather_plain` only for tensors on the CPU; both are
bit-exact against ``x[idx]``.  The kernel applies the fixup list itself,
in a second launch from the same C entry; the plain version uses tensor
indexing, as the JAX package leaves the fixup to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BandedGatherPlan", "banded_gather_plain", "banded_gather_cuda"]

launches = 0  # kernel launches of this process; only banded_gather_cuda adds to it


class BandedGatherPlan:
    """Host-built plan for repeated ``x[idx]`` with a fixed banded ``idx``.

    ``block_rows`` outputs per block; ``max_chunks`` caps the per-block
    window (outliers go to the fixup list).  Calls accept ``(n,)`` or
    ``(n, nv)`` tensors and are bit-exact against ``x[idx]``.  The plan's
    tensors live on ``device``.
    """

    MAX_CHUNKS = 64

    def __init__(self, idx, n_src: int, *, block_rows: int = 512,
                 fixup_frac: float = 0.01, device="cpu"):
        idx = np.asarray(idx, dtype=np.int64)
        if idx.ndim != 1:
            raise ValueError("idx must be 1-D (flatten ELL tables first)")
        if idx.size and (idx.min() < 0 or idx.max() >= n_src):
            raise ValueError("idx out of range")
        R = block_rows
        if R % 128:
            raise ValueError("block_rows must be a multiple of 128")
        dev = torch.device(device)
        self.launches = 0  # kernel launches through this plan
        m = idx.size
        self.m, self.n_src, self.R = m, n_src, R
        nb = max(-(-m // R), 1)
        mp = nb * R
        # Pad with the last real index so padding cannot widen the last
        # block's window.
        fill = idx[-1] if m else 0
        pad_idx = np.full(mp, fill, dtype=np.int64)
        pad_idx[:m] = idx
        blocks = pad_idx.reshape(nb, R)
        real = np.zeros(mp, dtype=bool)
        real[:m] = True
        real = real.reshape(nb, R)
        # Median-centered per-block windows; C = smallest multiple of 128
        # whose out-of-window count fits the fixup budget.
        center = np.median(blocks, axis=1).astype(np.int64)
        c_max = (int(max(blocks.max() - blocks.min(), 0)) // 128 + 3) * 128
        C = c_max
        for c in range(128, c_max + 1, 128):
            start128 = np.maximum(center - c // 2, 0) // 128 * 128
            local = blocks - start128[:, None]
            n_out = int((((local < 0) | (local >= c)) & real).sum())
            if n_out <= fixup_frac * max(m, 1):
                C = c
                break
        self.xla_fallback = C // 128 > self.MAX_CHUNKS
        self.full_idx = None
        zi = torch.zeros((0,), dtype=torch.int32, device=dev)
        if self.xla_fallback:
            self.full_idx = torch.as_tensor(idx.astype(np.int32), device=dev)
            self.window = 0
            self.src_rows = 0
            self.sub = R // 128
            self.n_chunks = 0
            self.fix_pos = zi
            self.fix_idx = zi
            self.lidx = torch.zeros((0, self.sub, 128), dtype=torch.int32, device=dev)
            self.starts = zi
            return
        start128 = np.maximum(center - C // 2, 0) // 128 * 128
        # Clamp so start + C stays inside the padded source.
        src_rows = -(-n_src // 128) + C // 128
        self.src_rows = src_rows
        start128 = np.minimum(start128, (src_rows - C // 128) * 128)
        local = blocks - start128[:, None]
        out = (local < 0) | (local >= C)
        self.window = C
        fix_pos = np.nonzero((out & real).reshape(-1)[:m])[0]
        self.fix_pos = torch.as_tensor(fix_pos.astype(np.int32), device=dev)
        self.fix_idx = torch.as_tensor(idx[fix_pos].astype(np.int32), device=dev)
        local = np.where(out, C, local)
        sub = R // 128
        self.sub = sub
        self.lidx = torch.as_tensor(local.reshape(nb, sub, 128).astype(np.int32), device=dev)
        self.n_chunks = C // 128
        self.starts = torch.as_tensor((start128 // 128).astype(np.int32), device=dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.xla_fallback:
            return x[self.full_idx]
        if x.device.type == "cpu":
            return banded_gather_plain(self, x)
        return banded_gather_cuda(self, x)


def banded_gather_plain(plan: BandedGatherPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version: the plan applied with tensor indexing."""
    lidx = plan.lidx.reshape(-1)[: plan.m].long()
    block = torch.arange(plan.m, device=x.device) // plan.R
    src = 128 * plan.starts.long()[block] + lidx
    hit = lidx < plan.window
    y = x[torch.where(hit, src, 0)]
    hit = hit.reshape((-1,) + (1,) * (x.dim() - 1))
    y = torch.where(hit, y, torch.zeros((), dtype=x.dtype, device=x.device))
    if plan.fix_pos.numel():
        y[plan.fix_pos] = x[plan.fix_idx]
    return y


def banded_gather_cuda(plan: BandedGatherPlan, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (gather plus fixup); raises on what it does not
    take."""
    global launches
    from stormx_torch.ops import _cuda

    if not (x.is_cuda and plan.lidx.is_cuda):
        raise ValueError("banded_gather_cuda needs CUDA tensors")
    if x.device != plan.lidx.device:
        raise ValueError("plan and x lie on different devices")
    if plan.xla_fallback:
        raise ValueError("a fallback plan has no kernel metadata")
    if x.dim() not in (1, 2) or x.shape[0] != plan.n_src:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({plan.n_src}[, nv])")
    if not x.is_contiguous():
        raise ValueError("banded_gather_cuda needs a contiguous x")
    nv = 1 if x.dim() == 1 else x.shape[1]
    y = torch.empty((plan.m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    lib = _cuda.library("banded_gather")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_banded_gather(
            plan.starts.data_ptr(), plan.lidx.data_ptr(), plan.fix_pos.data_ptr(),
            plan.fix_idx.data_ptr(), x.data_ptr(), y.data_ptr(), plan.m, plan.n_src,
            plan.fix_pos.numel(), plan.R, plan.window, nv, x.element_size(), stream,
        )
    _cuda.check(lib, rc, "banded_gather")
    launches += 1
    plan.launches += 1
    return y
