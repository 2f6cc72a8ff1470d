"""K3: the banded gather ``y = x[idx]`` (counterpart of
``stormx/ops/pallas_gather.py``).

:class:`BandedGatherPlan` keeps the JAX package's host plan build
unchanged: per-block window starts (``starts``), window-local indices
(``lidx``, with ``C`` marking an out-of-window row), the fixup list
(``fix_pos``, ``fix_idx``) and the wide-map fallback (``xla_fallback``: a
map wider than ``MAX_CHUNKS`` windows of 128 runs as a plain gather, the
package's own policy).  Beside them it builds the kernel's one array,
``word``: per output row the window-local index, or ``−1 − idx`` for a
fixup row, so that one pass gathers every row.  A call launches the CUDA
kernel ``csrc/banded_gather.cu`` (one launch) for tensors on the card and
takes the plain version :func:`banded_gather_plain`, which reads the same
words, only for tensors on the CPU; both are bit-exact against ``x[idx]``
for every dtype (the kernel copies raw bits, a complex128 item as two
8-byte words).
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import resolve_device

__all__ = ["BandedGatherPlan", "banded_gather_plain", "banded_gather_cuda", "empty_launch"]

launches = 0  # kernel launches of this process; only banded_gather_cuda adds to it


class BandedGatherPlan:
    """Host-built plan for repeated ``x[idx]`` with a fixed banded ``idx``.

    ``block_rows`` outputs per block; ``max_chunks`` caps the per-block
    window (outliers go to the fixup list).  Calls accept ``(n,)`` or
    ``(n, nv)`` tensors and are bit-exact against ``x[idx]``.  The plan's
    tensors live on ``device``, the card unless the caller asks for the CPU
    (raises when CUDA is asked for and absent).
    """

    MAX_CHUNKS = 64

    def __init__(self, idx, n_src: int, *, block_rows: int = 512,
                 fixup_frac: float = 0.01, device="cuda"):
        dev = resolve_device(device)
        idx = np.asarray(idx, dtype=np.int64)
        if idx.ndim != 1:
            raise ValueError("idx must be 1-D (flatten ELL tables first)")
        if idx.size and (idx.min() < 0 or idx.max() >= n_src):
            raise ValueError("idx out of range")
        R = block_rows
        if R % 128:
            raise ValueError("block_rows must be a multiple of 128")
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
            self.word = zi
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
        # The kernel's word: the window-local index in the window, −1 − idx
        # outside it (the fixup rows; idx < 2³¹ as the JAX plan's int32 needs).
        self.word = torch.as_tensor(np.where(out, -1 - blocks, local).reshape(-1)
                                    .astype(np.int32), device=dev)
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


def decode_word(plan: BandedGatherPlan) -> torch.Tensor:
    """The source row of each output row, read from the kernel's words
    (int64, on the plan's device): ``128·starts[b] + word`` in the window,
    ``−1 − word`` outside it."""
    word = plan.word[: plan.m].long()
    block = torch.arange(plan.m, device=word.device) // plan.R
    return torch.where(word >= 0, 128 * plan.starts.long()[block] + word, -1 - word)


def banded_gather_plain(plan: BandedGatherPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version: one pass through the kernel's words, as tensor
    indexing."""
    return x[decode_word(plan).to(x.device)]


def banded_gather_cuda(plan: BandedGatherPlan, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (one launch per call); raises on what it does
    not take."""
    global launches
    from stormx_torch.ops import _cuda

    if not (x.is_cuda and plan.word.is_cuda):
        raise ValueError("banded_gather_cuda needs CUDA tensors")
    if x.device != plan.word.device:
        raise ValueError("plan and x lie on different devices")
    if plan.xla_fallback:
        raise ValueError("a fallback plan has no kernel metadata")
    if x.dim() not in (1, 2) or x.shape[0] != plan.n_src:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({plan.n_src}[, nv])")
    if not x.is_contiguous():
        raise ValueError("banded_gather_cuda needs a contiguous x")
    nv = 1 if x.dim() == 1 else x.shape[1]
    y = torch.empty((plan.m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _cuda.library("banded_gather")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_banded_gather(plan.starts.data_ptr(), plan.word.data_ptr(),
                                      x.data_ptr(), y.data_ptr(), plan.m, plan.R, nv,
                                      x.element_size(), stream)
    _cuda.check(lib, rc, "banded_gather")
    launches += 1
    plan.launches += 1
    return y


def empty_launch(blocks: int, device) -> None:
    """Launch an empty kernel of ``blocks`` blocks of 128 threads: the card's
    fixed cost per launch, the yardstick under K3's time.  Measurement only;
    no path calls it, and it counts no launch."""
    from stormx_torch.ops import _cuda

    lib = _cuda.library("banded_gather")
    with torch.cuda.device(device):
        rc = lib.stormx_empty_launch(blocks, torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, rc, "empty_launch")
