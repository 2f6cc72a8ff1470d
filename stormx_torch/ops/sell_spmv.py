"""K1: the SlicedELL SpMV ``y = A·x`` (counterpart of
``stormx/ops/pallas_sell.py``).

:func:`sell_spmv` launches the CUDA kernel ``csrc/sell_spmv.cu`` for tensors
on the card and takes the plain PyTorch version :func:`sell_spmv_plain` only
for tensors on the CPU.  The kernel wants float32, like the TPU kernel, and
no row-block restriction.  The K-sum order differs between the plain
version and the kernel (the kernel accumulates k = 0..K−1 with FMAs), so
they agree to float32 roundoff, not bit for bit.

The kernel has two branches, which give the same y bit for bit: "rows"
(one thread a row) and "staged" (a persistent grid whose blocks copy tiles
of :func:`staged_geometry`'s T row blocks into a ring in shared memory with
bulk asynchronous copies).  :func:`k1_branch` picks one from the operator's
shape and the card's numbers before the launch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from stormx_torch.core import profiling

__all__ = ["sell_spmv", "sell_spmv_plain", "sell_spmv_cuda", "supports_kernel",
           "StagedGeometry", "staged_geometry", "ring_bytes", "k1_branch", "branch_of",
           "check_branch", "BRANCHES"]

launches = 0  # kernel launches of this process; only sell_spmv_cuda adds to it
BRANCHES = ("staged", "rows")
branch_launches = dict.fromkeys(BRANCHES, 0)  # the same launches, by branch
_count_lock = threading.Lock()  # ranks that share a card are threads of one process

# The staged branch's tile geometry: a tile holds T row blocks, about
# TILE_ROWS_PER_SLOT·K rows but no more than MAX_STAGE_BYTES of values and
# columns; STAGES stages a ring; a consumer thread takes ROWS_PER_THREAD
# (kRowsPerThread of csrc/sell_spmv.cu) consecutive rows of a tile, at most
# MAX_CONSUMERS (kMaxConsumers) a block beside a producer warp.  The branch
# rule gives "staged" operators of at least MIN_STAGED_K slots a row and
# MIN_BLOCKS_PER_SM row blocks an SM.  Chosen on an H100
# (scripts/torch_k1_variants.py).
TILE_ROWS_PER_SLOT = 64
MAX_STAGE_BYTES = 64 * 1024  # of values and columns
STAGES = 2
MAX_CONSUMERS = 512
ROWS_PER_THREAD = 2
MIN_BLOCKS_PER_SM = 2
MIN_STAGED_K = 10
_INT32_LIMIT = 2**31


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


# -- the staged branch's geometry and the branch rule (host only) ---------------


@dataclass(frozen=True)
class StagedGeometry:
    """Tiles of ``tile_blocks`` (T) row blocks in a ring of ``stages`` (S),
    ``consumers`` threads a block beside the producer warp; ``tiles`` of
    them cover the operator, and the ring takes ``smem_bytes``."""

    tile_blocks: int
    stages: int
    consumers: int
    tiles: int
    smem_bytes: int


def ring_bytes(T: int, S: int, K: int, R: int) -> int:
    """Shared memory of one staged block: S stages of T·K·R values and as
    many columns, 4 bytes each, and two 8-byte mbarriers a stage."""
    return 2 * S * T * K * R * 4 + 2 * S * 8


def staged_geometry(nb: int, K: int, R: int, sms: int) -> StagedGeometry:
    """The staged branch's tiles for ``nb`` row blocks of K slots and R rows
    on a card of ``sms`` SMs: T row blocks a tile, as many as hold
    TILE_ROWS_PER_SLOT·K rows within MAX_STAGE_BYTES, but no more than leave
    MIN_BLOCKS_PER_SM tiles for each SM, at least 1; a consumer thread for
    every ROWS_PER_THREAD rows of a tile, in whole warps, at most
    MAX_CONSUMERS."""
    T = max(1, min(TILE_ROWS_PER_SLOT * K // R, MAX_STAGE_BYTES // (8 * K * R),
                   nb // max(MIN_BLOCKS_PER_SM * sms, 1)))
    consumers = min(MAX_CONSUMERS, -(-T * R // (32 * ROWS_PER_THREAD)) * 32)
    return StagedGeometry(tile_blocks=T, stages=STAGES, consumers=consumers,
                          tiles=-(-nb // T), smem_bytes=ring_bytes(T, STAGES, K, R))


def _staged_shape_error(nb: int, K: int, R: int, n_cols: int, geometry: StagedGeometry,
                        smem_optin: int) -> str | None:
    """Why the staged branch cannot take this shape, or None."""
    if R % 4:
        return (f"R = {R} is not a multiple of 4 (its bulk copies move 16-byte units, and a"
                " thread's rows lie in one block)")
    if nb * R >= _INT32_LIMIT or n_cols >= _INT32_LIMIT:
        return "its 32-bit index math needs nb·R and n_cols under 2^31"
    if geometry.smem_bytes > smem_optin:
        return (f"its ring needs {geometry.smem_bytes} bytes of shared memory at T = "
                f"{geometry.tile_blocks}, S = {geometry.stages}, K = {K}, R = {R}, over the "
                f"card's opt-in limit of {smem_optin}")
    return None


def k1_branch(nb: int, K: int, R: int, n_cols: int, *, sms: int, smem_optin: int) -> str:
    """K1's branch for an operator of ``nb`` row blocks of K slots and R
    rows over ``n_cols`` columns, on a card of ``sms`` SMs whose blocks may
    opt in to ``smem_optin`` bytes of shared memory: "staged" when its
    geometry takes the shape, the rows hold MIN_STAGED_K slots or more and
    the operator has MIN_BLOCKS_PER_SM row blocks an SM, else "rows".  On an
    H100 with L2 warm, as a Krylov loop finds these operators, "rows" was
    the faster at fewer slots (K = 2..8 at 2,488 row blocks; the smoke's
    K = 4 operators) or fewer blocks (the slab product's block ranges), and
    "staged" level or faster at K = 10 (the Cahn–Hilliard operator) and 16
    (scripts/torch_k1_variants.py --sweep)."""
    if K < MIN_STAGED_K or nb < MIN_BLOCKS_PER_SM * sms:
        return "rows"
    geometry = staged_geometry(nb, K, R, sms)
    return "rows" if _staged_shape_error(nb, K, R, n_cols, geometry, smem_optin) else "staged"


def check_branch(sell, branch: str, *, sms: int, smem_optin: int) -> StagedGeometry | None:
    """Raise ``ValueError`` when ``branch`` cannot take ``sell``: an unknown
    branch, and for "staged" a shape its geometry does not take (a ring
    over the opt-in limit among them) or values and columns that are not
    16-byte aligned.  Returns the staged geometry, None for "rows"."""
    if branch not in BRANCHES:
        raise ValueError(f"unknown K1 branch {branch!r}; choose one of {BRANCHES}")
    if branch == "rows":
        return None
    nb, K, R = sell.data.shape
    geometry = staged_geometry(nb, K, R, sms)
    why = _staged_shape_error(nb, K, R, sell.shape[1], geometry, smem_optin)
    if why:
        raise ValueError(f"K1's staged branch cannot take this operator: {why}")
    if sell.data.data_ptr() % 16 or sell.local_cols.data_ptr() % 16:
        raise ValueError("K1's staged branch bulk-copies data and local_cols: align both to"
                         " 16 bytes")
    return geometry


# -- the card ---------------------------------------------------------------------

_card: dict[int, tuple[int, int]] = {}  # device index -> (SMs, shared-memory opt-in)


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def card_numbers(device) -> tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of ``device``, read once."""
    from stormx_torch.ops import _cuda

    index = _index(device)
    if index not in _card:
        lib = _cuda.library("sell_spmv")
        optin = lib.stormx_sell_smem_optin(index)
        _cuda.check(lib, max(-optin, 0), "sell_smem_optin")
        _card[index] = (torch.cuda.get_device_properties(index).multi_processor_count, optin)
    return _card[index]


def branch_of(sell) -> str:
    """The branch :func:`sell_spmv_cuda` launches for ``sell`` on its card."""
    nb, K, R = sell.data.shape
    sms, optin = card_numbers(sell.data.device)
    return k1_branch(nb, K, R, sell.shape[1], sms=sms, smem_optin=optin)


# (device, nb, K, R, n_cols, 16-byte aligned, branch asked for) -> (branch,
# staged geometry or None, staged grid): what a launch decides from the
# operator's shape, decided once.
_plans: dict[tuple, tuple[str, StagedGeometry | None, int]] = {}


def _plan(sell, branch: str | None) -> tuple[str, StagedGeometry | None, int]:
    """The branch, and for "staged" its geometry and a persistent grid of
    the SMs times the blocks an SM holds (the card's occupancy calculator)."""
    from stormx_torch.ops import _cuda

    nb, K, R = sell.data.shape
    index = _index(sell.data.device)
    sms, optin = card_numbers(index)
    if branch is None:
        branch = k1_branch(nb, K, R, sell.shape[1], sms=sms, smem_optin=optin)
    g = check_branch(sell, branch, sms=sms, smem_optin=optin)
    if g is None:
        return branch, None, 0
    lib = _cuda.library("sell_spmv")
    with torch.cuda.device(index):
        blocks = lib.stormx_sell_staged_blocks_per_sm(g.tile_blocks, g.stages, K, R,
                                                      g.consumers)
    _cuda.check(lib, max(-blocks, 0), "sell_staged_blocks_per_sm")
    if blocks < 1:
        raise ValueError(f"no block of K1's staged branch fits an SM at {g}")
    return branch, g, min(g.tiles, sms * blocks)


def sell_spmv_cuda(sell, x: torch.Tensor, *, branch: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel; raises on what it does not take.  ``branch``
    forces "staged" or "rows" (measurement only); by default
    :func:`k1_branch` picks it from the operator's shape.  While a profiler
    records, the call is the span ``k1.launch``."""
    if not profiling.recording():
        return _sell_spmv_cuda(sell, x, branch)
    with profiling.annotate("k1.launch"):
        return _sell_spmv_cuda(sell, x, branch)


def _sell_spmv_cuda(sell, x: torch.Tensor, branch: str | None) -> torch.Tensor:
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
    data_ptr, cols_ptr = data.data_ptr(), cols.data_ptr()
    key = (x.device.index, nb, K, R, n_cols, not (data_ptr | cols_ptr) % 16, branch)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(sell, branch)
    branch, geometry, grid = plan
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lib = _cuda.library("sell_spmv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if geometry is None:
            rc = lib.stormx_sell_spmv(data_ptr, cols_ptr, x.data_ptr(), y.data_ptr(), n_rows,
                                      n_cols, R, K, sell.pad_lo, stream)
        else:
            rc = lib.stormx_sell_spmv_staged(
                data_ptr, cols_ptr, x.data_ptr(), y.data_ptr(), n_rows, n_cols, nb, R, K,
                sell.pad_lo, geometry.tile_blocks, geometry.stages, geometry.consumers, grid,
                stream)
    _cuda.check(lib, rc, f"sell_spmv ({branch})")
    with _count_lock:
        launches += 1
        branch_launches[branch] += 1
    return y


def sell_spmv(sell, x: torch.Tensor) -> torch.Tensor:
    """y = A·x: the kernel for tensors on the card, the plain version for
    tensors on the CPU."""
    if x.device.type == "cpu":
        return sell_spmv_plain(sell, x)
    return sell_spmv_cuda(sell, x)
