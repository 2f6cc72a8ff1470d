"""K3: the banded gather ``y = x[idx]`` (counterpart of
``stormx/ops/pallas_gather.py``).

:class:`BandedGatherPlan` keeps the JAX package's host plan build
unchanged: per-block window starts (``starts``), window-local indices
(``lidx``, with ``C`` marking an out-of-window row), the fixup list
(``fix_pos``, ``fix_idx``) and the wide-map flag (``xla_fallback``: a map
wider than ``MAX_CHUNKS`` windows of 128, which the JAX plan gathers
plainly).  Beside them it builds the kernel's two arrays: per block the
base of its words (``word_starts``, in units of 128 rows) and per output
row its ``word``, the index less ``128·word_starts[block]``, or ``−1 −
idx`` for a fixup row, so that one pass gathers every row.  The kernel
reads any index either way, so a wide map needs no window: its one base is
0 and its words are the indices themselves.  A call launches the CUDA
kernel ``csrc/banded_gather.cu`` (one launch) for tensors on the card,
whatever the map's width, and takes the plain version
:func:`banded_gather_plain`, which reads the same words, only for tensors
on the CPU; both are bit-exact against ``x[idx]`` for every dtype (the
kernel copies raw bits, a complex128 item as two 8-byte words).

The kernel has three branches, all one launch of one block per ``R``
rows: "vec4" (4-byte scalar fields, four rows a thread), "vector" (rows of
several components moved as 16-, 8- or 4-byte vectors through a table of
source rows that each block decodes once) and "scalar" (one thread per
component, for the rest).  :func:`k3_branch`
picks one from the field's shape and alignment, once per shape.
"""

from __future__ import annotations

import collections
import weakref

import numpy as np
import torch

from stormx_torch.core.config import resolve_device

__all__ = ["BandedGatherPlan", "banded_gather_plain", "banded_gather_cuda", "empty_launch",
           "BRANCHES", "k3_branch", "check_branch", "branch_of", "vector_bytes", "live_plans"]

launches = 0  # kernel launches of this process; only banded_gather_cuda adds to it
BRANCHES = ("vec4", "vector", "scalar")
branch_launches = dict.fromkeys(BRANCHES, 0)  # the same launches, by branch
_BRANCH_CODES = {b: i for i, b in enumerate(BRANCHES)}  # the C entry's `branch`
# The vector branch takes rows of MIN_VECTOR_ROW_BYTES bytes or more whose
# bytes and bases admit 4-byte vectors at least, in blocks of at most
# MAX_TABLE_ROWS rows (its table of source rows: 48 KB of int32, the
# shared memory a block gets without opting in).  Chosen on an H100
# (scripts/torch_k3_variants.py --sweep).
MIN_VECTOR_ROW_BYTES = 8
MAX_TABLE_ROWS = 12 * 1024
_live = weakref.WeakSet()  # every plan not yet freed, for ops/capture.py's counters


def live_plans() -> list:
    """The plans not yet freed (whose launch counters a capture moves)."""
    return list(_live)


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
        # Kernel launches through this plan, by (nv, dtype) of the gathered
        # field, and by (nv, dtype, branch).
        self.launches_by_shape = collections.Counter()
        self.launches_by_branch = collections.Counter()
        _live.add(self)
        self._choices = {}  # the kernel's launch decisions by shape (banded_gather_cuda)
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
        zi = torch.zeros((0,), dtype=torch.int32, device=dev)
        if self.xla_fallback:
            # The JAX plan's fields stay empty, as there; the kernel's words
            # are the indices themselves (base 0; idx < 2³¹, as for the JAX
            # plan's int32).
            self.word_starts = torch.zeros((nb,), dtype=torch.int32, device=dev)
            self.word = torch.as_tensor(pad_idx.astype(np.int32), device=dev)
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
        self.word_starts = self.starts

    @property
    def launches(self) -> int:
        """Kernel launches through this plan."""
        return sum(self.launches_by_shape.values())

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return banded_gather_plain(self, x)
        # The JAX plan takes any array; column views and transposes are
        # copied here (only when not contiguous), and the kernel entry keeps
        # its own check.
        return banded_gather_cuda(self, x.contiguous())


def decode_word(plan: BandedGatherPlan) -> torch.Tensor:
    """The source row of each output row, read from the kernel's words
    (int64, on the plan's device): ``128·word_starts[b] + word`` in the
    window, ``−1 − word`` outside it."""
    word = plan.word[: plan.m].long()
    block = torch.arange(plan.m, device=word.device) // plan.R
    return torch.where(word >= 0, 128 * plan.word_starts.long()[block] + word, -1 - word)


def banded_gather_plain(plan: BandedGatherPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version: one pass through the kernel's words, as tensor
    indexing."""
    return x[decode_word(plan).to(x.device)]


# -- the branch rule (host only) -------------------------------------------------


def _words(nv: int, itemsize: int) -> tuple[int, int]:
    """(components, bytes each) as the kernel sees a row: a 16-byte item
    (complex128) is two 8-byte words."""
    return (2 * nv, 8) if itemsize == 16 else (nv, itemsize)


def vector_bytes(row_bytes: int, *addresses: int) -> int:
    """The widest of 16, 8 and 4 bytes that divides ``row_bytes`` and every
    address, or 0: rows moved in such vectors start on one and end on one."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and all(a % v == 0 for a in addresses):
            return v
    return 0


def _width(branch: str, nv: int, itemsize: int, R: int, x_addr: int, y_addr: int,
           word_addr: int) -> int:
    """The bytes ``branch`` moves at a time on this shape, 0 when it cannot
    take it: "vec4" 4-byte scalar fields whose words and y are 16-byte
    aligned (R % 4 == 0); "vector" rows that :func:`vector_bytes` gives a
    width, R ≤ MAX_TABLE_ROWS; "scalar" anything."""
    nv_w, size_w = _words(nv, itemsize)
    if branch == "vec4":
        takes = size_w == 4 and nv_w == 1 and (word_addr | y_addr) % 16 == 0 and R % 4 == 0
        return 16 if takes else 0
    if branch == "vector":
        return vector_bytes(nv_w * size_w, x_addr, y_addr) if R <= MAX_TABLE_ROWS else 0
    return size_w


def k3_branch(nv: int, itemsize: int, R: int, *, x_addr: int, y_addr: int,
              word_addr: int) -> tuple[str, int]:
    """K3's branch for a field of ``nv`` components of ``itemsize`` bytes a
    row, gathered in blocks of ``R`` rows from address ``x_addr`` to
    ``y_addr`` through words at ``word_addr``, and the bytes it moves at a
    time: "vec4" where it takes the shape, else "vector" for rows of
    MIN_VECTOR_ROW_BYTES or more where it takes them, else "scalar".  Only
    the addresses modulo 16 matter."""
    shape = (nv, itemsize, R, x_addr, y_addr, word_addr)
    if _width("vec4", *shape):
        return "vec4", 16
    v = _width("vector", *shape)
    if v and nv * itemsize >= MIN_VECTOR_ROW_BYTES:
        return "vector", v
    return "scalar", _width("scalar", *shape)


def check_branch(branch: str, nv: int, itemsize: int, R: int, *, x_addr: int, y_addr: int,
                 word_addr: int) -> int:
    """The bytes ``branch`` moves at a time on this shape; raises
    ``ValueError`` when it cannot take it (measurement forces a branch;
    the path takes :func:`k3_branch`'s)."""
    if branch not in BRANCHES:
        raise ValueError(f"unknown K3 branch {branch!r}; choose one of {BRANCHES}")
    v = _width(branch, nv, itemsize, R, x_addr, y_addr, word_addr)
    if not v:
        raise ValueError(f"K3's {branch} branch cannot take {nv} components of {itemsize} "
                         f"bytes, x at {x_addr % 16} and y at {y_addr % 16} modulo 16, words "
                         f"at {word_addr % 16}, R = {R}")
    return v


def branch_of(plan: BandedGatherPlan, x: torch.Tensor) -> str:
    """The branch :func:`banded_gather_cuda` launches for ``x`` through
    ``plan`` (y, a fresh allocation, is 16-byte aligned)."""
    nv = 1 if x.dim() == 1 else x.shape[1]
    return k3_branch(nv, x.element_size(), plan.R, x_addr=x.data_ptr(), y_addr=0,
                     word_addr=plan.word.data_ptr())[0]


def banded_gather_cuda(plan: BandedGatherPlan, x: torch.Tensor, *,
                       branch: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (one launch per call); raises on what it does
    not take.  ``branch`` forces one of BRANCHES (measurement only); by
    default :func:`k3_branch` picks it from the shape.  What a launch
    decides from the shape is decided once per (nv, dtype, x's address
    modulo 16, branch asked for) and kept on the plan, whose R and words
    are fixed; y is a fresh allocation, 16-byte aligned (the C entry
    checks every alignment again)."""
    global launches
    from stormx_torch.ops import _cuda

    if not (x.is_cuda and plan.word.is_cuda):
        raise ValueError("banded_gather_cuda needs CUDA tensors")
    if x.device != plan.word.device:
        raise ValueError("plan and x lie on different devices")
    if x.dim() not in (1, 2) or x.shape[0] != plan.n_src:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({plan.n_src}[, nv])")
    if not x.is_contiguous():
        raise ValueError("banded_gather_cuda needs a contiguous x")
    nv = 1 if x.dim() == 1 else x.shape[1]
    y = torch.empty((plan.m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    x_ptr = x.data_ptr()
    key = (nv, x.dtype, x_ptr & 15, branch)
    choice = plan._choices.get(key)
    if choice is None:
        shape = dict(nv=nv, itemsize=x.element_size(), R=plan.R, x_addr=x_ptr, y_addr=0,
                     word_addr=plan.word.data_ptr())
        b, vec = (k3_branch(**shape) if branch is None
                  else (branch, check_branch(branch, **shape)))
        choice = plan._choices[key] = (b, _BRANCH_CODES[b], vec, shape["itemsize"],
                                       (nv, x.dtype), (nv, x.dtype, b))
    branch, code, vec, itemsize, shape_key, branch_key = choice
    lib = _cuda.library("banded_gather")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_banded_gather(plan.word_starts.data_ptr(), plan.word.data_ptr(), x_ptr,
                                      y.data_ptr(), plan.m, plan.R, nv, itemsize, code, vec,
                                      stream)
    if rc:
        _cuda.check(lib, rc, f"banded_gather ({branch})")
    launches += 1
    branch_launches[branch] += 1
    plan.launches_by_shape[shape_key] += 1
    plan.launches_by_branch[branch_key] += 1
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
