"""T1 and T2: the sparse triangular solve's kernels (``csrc/tri_solve.cu``)
and their plain versions, for :func:`stormx_torch.precond.tri_solve`.

They stand for the JAX package's level loop (an XLA program,
``stormx/precond/triangular.py:146-175``), not for a Pallas kernel:

* T1, :func:`exact_cuda`: the exact solve ``(D + N)·y = r`` in one launch,
  in one of two branches that give the same y bit for bit, picked by
  :func:`t1_branch` from the factor's shape:

  - "grid": one cooperative launch, a warp for every strand of the factor
    (``precond.triangular.strands``: chains of rows each reading the one
    before it, as many strands as the widest level has rows), its lanes
    holding the strand's next 32 rows (:func:`grid_slots` slots each at
    once) and polling the ready flags of their dependencies in other
    strands (no barrier per level), the strand's rows solved in turn with
    the link's y passed by shuffle, behind a memset of the solve's own flag
    words.  A wait
    longer than ``WATCHDOG_S`` on one row, or a column outside ``[0, n)``,
    ends the launch with NaN in the rows it could not solve.
  - "block": one block on one SM walks the positions in passes of 512, a
    barrier between passes; a row waits on the rows of its own pass that it
    reads through tagged words in shared memory; a producer warp streams
    the factor's position-order arrays into rings in shared memory ahead of
    the consumers (:func:`block_geometry`).  A dependency outside the
    earlier levels gives its row NaN.

  The host does not wait for either: each launch copies its two error words
  to pinned host words of a reused slot and records the slot's event, and
  an error raises :class:`StormError` at the next T1 call that finds the
  solve ended, or at :func:`check_watchdog`, which waits for every solve
  launched.  So a captured graph could not replay T1: it calls
  ``capture.refuse`` first, which raises :class:`CaptureRefusedError`
  while the stream captures, before T1 takes a slot, reads an error word
  or allocates, and otherwise counts the call.
* T2, :func:`sweep_cuda`: ``sweeps`` Jacobi sweeps ``y ← D⁻¹(r − N·y)``,
  one launch a sweep, the first forming ``y0 = D⁻¹·r`` inline.

The plain versions (:func:`exact_plain`, :func:`sweep_plain`) add each
row's ELL slots in slot order, one rounded multiply and one rounded add a
slot (:func:`slot_sum`), and the kernels do the same, so in float32 and
float64 they agree bit for bit wherever y is finite (T1 skips the padding
slots, which the plain version adds as ±0·y[0]).  Complex products are
written out in the kernels in one order; they agree with the plain
versions to a few ulps, and T1's two branches with each other bit for bit.
The public functions launch the kernel for tensors on the card and take
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from dataclasses import dataclass

import torch

from stormx_torch.core import profiling
from stormx_torch.core.exceptions import StormError
from stormx_torch.ops import capture

__all__ = [
    "exact",
    "sweep",
    "exact_plain",
    "sweep_plain",
    "exact_cuda",
    "sweep_cuda",
    "slot_sum",
    "scratch_words",
    "check_watchdog",
    "l2_chase_ns",
    "flag_hop_ns",
    "block_level_ns",
    "t1_branch",
    "grid_slots",
    "round_robin_strands",
    "BlockGeometry",
    "block_geometry",
    "block_smem_bytes",
    "BRANCHES",
    "MAX_BLOCK_MEAN_WIDTH",
    "MAX_BLOCK_RULE_K",
    "WATCHDOG_S",
]

# Kernel launches of this process, by kernel; only the *_cuda functions add to them.
launches = {"tri_exact": 0, "tri_sweep": 0}
BRANCHES = ("block", "grid")
branch_launches = dict.fromkeys(BRANCHES, 0)  # T1's launches again, by branch
# T1 "grid"'s slots a lane at once built (csrc/tri_solve.cu, exact_slots).
GRID_SLOTS = (1, 2, 4, 8)
# T1 "grid"'s launches again, by the slots a lane holds at once (grid_slots)
slot_launches = dict.fromkeys(GRID_SLOTS, 0)
# Seconds one lane of T1 "grid" may wait on one row's dependencies.  A
# legitimate wait is bounded by the strand's rows ahead of it (32, under
# 1 µs a level); passing it means the factor's strands or columns are
# corrupt.
WATCHDOG_S = 2.0
SCRATCH_HEADER = 4  # words before T1 "grid"'s ready flags (csrc/tri_solve.cu, Header)
_ERROR_MESSAGES = {1: "a wait on its dependencies passed the watchdog",
                   2: "a column lies outside [0, n)",
                   3: "a dependency lies outside the earlier levels"}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}
_NOT_READY = 600  # cudaErrorNotReady

# T1 "block"'s geometry (csrc/tri_solve.cu): the threads of its block
# (kBlockThreads: 512 consumers and the producer warp), the most slots a
# row it takes (kBlockMaxK), the chunks its r gather runs behind its bulk
# copies (kLag).  The ring holds D stages of S positions, both powers of
# two, D at least ceil(T/S) + BLOCK_LAG + 2; the wrapper takes the largest S
# of CHUNK_ROWS whose least ring and least window fit, then a window of up
# to MAX_WINDOW_BYTES, then as many stages as fit, up to MAX_STAGES.
BLOCK_THREADS = 544
BLOCK_MAX_K = 8
BLOCK_LAG = 2
CHUNK_ROWS = (256, 128, 64, 32, 16)
MAX_WINDOW_BYTES = 32 * 1024
MAX_STAGES = 32
STATIC_SMEM = 64  # the kernel's static shared words, with room to spare
H100_SMEM_OPTIN = 232_448  # shared memory an H100 block may opt in to
# The branch rule: "block" for factors of at most MAX_BLOCK_RULE_K slots a
# row whose levels hold at most MAX_BLOCK_MEAN_WIDTH rows on average, "grid"
# for the rest.  On an H100 (scripts/torch_t1_variants.py --sides, PERF.md
# §6) "block" was ahead on a 10⁵-level chain (3.8×) and on the IC(0),
# ILU(0) and IQR factors of meshes of 4,802–19,602 cells (K = 2–3, 27–69
# rows a level: 1.05–1.24×), even at 86 rows (0.94–1.0×) and behind from
# 116 rows on (0.77–0.91×); on the SGS factors of the CH operator (K = 6–7)
# it was behind at every size (19–116 rows a level: 0.52–0.86×).
MAX_BLOCK_MEAN_WIDTH = 75
MAX_BLOCK_RULE_K = 3

# -- plain versions ----------------------------------------------------------


def slot_sum(vals: torch.Tensor, cols: torch.Tensor, y: torch.Tensor):
    """Σ_k vals[:, k]·y[cols[:, k]] added in slot order k = 0..K−1 from 0,
    each product and each sum rounded: the order the kernels reproduce."""
    acc = 0
    for k in range(vals.shape[1]):
        acc = acc + vals[:, k] * y[cols[:, k]]
    return acc


def exact_plain(tri, r: torch.Tensor) -> torch.Tensor:
    """Plain version of T1: the level loop, one level's rows at a time."""
    r_pad = torch.nn.functional.pad(r, (0, 1))
    y = torch.zeros_like(r_pad)
    for lev in range(tri.num_levels):
        rows = tri.level_rows[lev]  # (W,) padded with n
        acc = slot_sum(tri.ell_vals[rows], tri.ell_cols[rows], y)
        y.index_copy_(0, rows, (r_pad[rows] - acc) * tri.inv_diag[rows])
    return y[: tri.num_rows]


def sweep_plain(tri, r: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Plain version of ``sweeps`` T2 launches."""
    n = tri.num_rows
    inv_diag, vals, cols = tri.inv_diag[:n], tri.ell_vals[:n], tri.ell_cols[:n]
    y = inv_diag * r
    for _ in range(sweeps):
        y = inv_diag * (r - slot_sum(vals, cols, torch.nn.functional.pad(y, (0, 1))))
    return y


# -- T1 "block"'s geometry and the branch rule (host only) ---------------------


@dataclass(frozen=True)
class BlockGeometry:
    """A T1 "block" launch: ``threads`` (the consumers and a producer warp),
    chunks of ``chunk_rows`` (S) positions in a ring of ``stages`` (D), a
    window of ``window`` (W) positions' y, ``smem_bytes`` of dynamic shared
    memory in all."""

    threads: int
    chunk_rows: int
    stages: int
    window: int
    smem_bytes: int


def block_smem_bytes(S: int, D: int, K: int, W: int, itemsize: int) -> int:
    """Dynamic shared memory of a T1 "block" launch: a ring of D·S
    positions' values, column positions, inv_diag, info (16 bytes) and r,
    the window of W slots (each 32-bit word of a value beside its 32-bit
    tag), and three 8-byte mbarriers a stage (``block_smem_bytes`` of
    csrc/tri_solve.cu)."""
    return D * S * (K * (itemsize + 4) + 2 * itemsize + 16) + 2 * W * itemsize + 3 * D * 8


def _pow2_at_least(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def block_geometry(K: int, dtype: torch.dtype,
                   smem_optin: int = H100_SMEM_OPTIN) -> BlockGeometry | None:
    """T1 "block"'s geometry for rows of K slots of ``dtype`` on a card whose
    blocks may opt in to ``smem_optin`` bytes, or None when the branch
    cannot take them (K over BLOCK_MAX_K, or no ring fits)."""
    if not 1 <= K <= BLOCK_MAX_K or dtype not in _DTYPES:
        return None
    item = dtype.itemsize
    consumers = BLOCK_THREADS - 32
    room = smem_optin - STATIC_SMEM
    w_min = _pow2_at_least(2 * consumers)
    for S in CHUNK_ROWS:
        d_min = _pow2_at_least(-(-consumers // S) + BLOCK_LAG + 2)
        if block_smem_bytes(S, d_min, K, w_min, item) > room:
            continue
        W = w_min
        while 4 * W * item <= MAX_WINDOW_BYTES and block_smem_bytes(S, d_min, K, 2 * W,
                                                                    item) <= room:
            W *= 2
        D = d_min
        while 2 * D <= MAX_STAGES and block_smem_bytes(S, 2 * D, K, W, item) <= room:
            D *= 2
        return BlockGeometry(threads=BLOCK_THREADS, chunk_rows=S, stages=D, window=W,
                             smem_bytes=block_smem_bytes(S, D, K, W, item))
    return None


@functools.lru_cache(maxsize=4096)
def t1_branch(n: int, num_levels: int, K: int, dtype: torch.dtype,
              smem_optin: int = H100_SMEM_OPTIN) -> str:
    """T1's branch for a factor of ``n`` rows in ``num_levels`` levels, K
    slots a row, values of ``dtype``: "block" when K is at most
    MAX_BLOCK_RULE_K and the levels hold at most MAX_BLOCK_MEAN_WIDTH rows
    on average (few slots in narrow levels, where one SM's short hops win),
    else "grid".  Decided once per shape."""
    if K > MAX_BLOCK_RULE_K or block_geometry(K, dtype, smem_optin) is None:
        return "grid"
    return "block" if n <= MAX_BLOCK_MEAN_WIDTH * max(num_levels, 1) else "grid"


def grid_slots(K: int) -> int:
    """T1 "grid"'s slots a lane holds at once for rows of K slots: the power
    of two at or above K, at most 8 (a row of more takes passes of 8)."""
    return min(GRID_SLOTS[-1], _pow2_at_least(max(K, 1)))


def round_robin_strands(order: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``count`` strands of the rows in level order: strand s the rows
    ``order[s], order[s + count], ...``, so each strand's levels increase.
    T1 "grid"'s strands where a factor's own (one a row of its widest level)
    are more warps than the card holds at once."""
    n = order.numel()
    dev = order.device
    per = -(-n // count)
    pos = (torch.arange(count, device=dev)[:, None]
           + count * torch.arange(per, device=dev)[None, :]).reshape(-1)
    pos = pos[pos < n]
    lengths = torch.clamp(torch.div(n - 1 - torch.arange(count, device=dev), count,
                                    rounding_mode="floor") + 1, min=0)
    ptr = torch.zeros(count + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(lengths, 0)
    return order[pos].contiguous(), ptr


# -- kernels -----------------------------------------------------------------


def _checked(tri, r: torch.Tensor) -> int:
    """The kernels' dtype code; raises on what they do not take."""
    n = tri.num_rows
    arrays = (tri.ell_vals, tri.ell_cols, tri.inv_diag, tri.order, tri.row_len)
    if not r.is_cuda or any(a.device != r.device for a in arrays):
        raise ValueError("the tri_solve kernels need the factor and r on one CUDA device")
    if r.dtype not in _DTYPES or tri.ell_vals.dtype != r.dtype or tri.inv_diag.dtype != r.dtype:
        raise ValueError(f"the tri_solve kernels take a factor and r of one dtype among "
                         f"{list(_DTYPES)}; got {tri.ell_vals.dtype} and {r.dtype}")
    if any(a.dtype != torch.int32 for a in (tri.ell_cols, tri.order, tri.row_len)):
        raise ValueError("the factor's columns, order and row_len must be int32")
    if r.shape != (n,):
        raise ValueError(f"r must be a contiguous ({n},) tensor, got {tuple(r.shape)}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("the factor's tensors must be contiguous")
    return _DTYPES[r.dtype]


def _checked_block(tri, r: torch.Tensor) -> None:
    """Raise on position-order arrays that T1 "block" does not take."""
    n, K = tri.num_rows, tri.ell_vals.shape[1]
    if not tri.has_positions:
        raise ValueError("T1 \"block\" reads the position-order arrays, which this factor "
                         "does not carry: pass precond.triangular.with_positions(tri)")
    n_pad = tri.pos_info.shape[0]
    want = ((tri.pos_cols, (n_pad, K), torch.int32), (tri.pos_vals, (n_pad, K), r.dtype),
            (tri.pos_inv_diag, (n_pad,), r.dtype), (tri.pos_info, (n_pad, 4), torch.int32))
    for a, shape, dtype in want:
        if a.device != r.device or a.shape != shape or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"T1 \"block\" needs the position-order arrays as build_triangular "
                             f"makes them; got {tuple(a.shape)} {a.dtype} on {a.device}")
        if a.data_ptr() % 16:
            raise ValueError("T1 \"block\" bulk-copies the position-order arrays: align each "
                             "to 16 bytes")
    if n_pad < n or n_pad % 4:
        raise ValueError(f"the position-order arrays have {n_pad} rows; T1 \"block\" needs "
                         f"a multiple of 4 no less than n = {n}")


def scratch_words(n: int, dtype: torch.dtype) -> int:
    """32-bit words of one T1 "grid" solve's scratch for n rows of
    ``dtype``: the header and, a row, itemsize/4 flag words of 64 bits
    (stamp and 32 bits of y)."""
    return SCRATCH_HEADER + 2 * n * (dtype.itemsize // 4)


_smem_optin: dict[int, int] = {}  # device index -> the block opt-in of shared memory
_grid_warps: dict[tuple, int] = {}  # (device, dtype code, S) -> T1 "grid" warps resident


def _optin(lib, index: int) -> int:
    if index not in _smem_optin:
        optin = lib.stormx_tri_smem_optin(index)
        _check(lib, max(-optin, 0), "tri_smem_optin")
        _smem_optin[index] = optin
    return _smem_optin[index]


def _resident_warps(lib, index: int, code: int, slots: int) -> int:
    key = (index, code, slots)
    if key not in _grid_warps:
        with torch.cuda.device(index):
            warps = lib.stormx_tri_grid_warps(code, slots)
        _check(lib, max(-warps, 0), "tri_grid_warps")
        _grid_warps[key] = warps
    return _grid_warps[key]


def _check(lib, rc, what):
    from stormx_torch.ops import _cuda

    _cuda.check(lib, rc, what)


class _Launch(ctypes.Structure):
    """A factor's T1 launch as the C entries take it (``TriLaunch`` of
    csrc/tri_solve.cu): the arrays each branch reads and the shape."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "vals", "cols", "inv_diag", "order", "row_len",
        "pos_vals", "pos_cols", "pos_inv_diag", "pos_info")] + [
        (name, ctypes.c_int) for name in ("n", "n_pad", "K", "dtype", "S", "D", "W")] + [
        ("watchdog_s", ctypes.c_double)] + [
        (name, ctypes.c_int) for name in ("slots", "strands")] + [
        (name, ctypes.c_void_p) for name in ("strand_rows", "strand_ptr")]


# What a launch decides from a factor, checked and packed once: id(factor)
# -> (the call: branch asked for, r's dtype, device and length; weak
# references to the tensors the chosen branch reads; their versions; the
# plan: branch, n, the _Launch and its address).  A hit needs the same
# tensor objects at the same versions.
_plans: dict[int, tuple] = {}
_MAX_PLANS = 512
_READS = {"grid": ("ell_vals", "ell_cols", "inv_diag", "row_len", "strand_rows", "strand_ptr"),
          "block": ("pos_vals", "pos_cols", "pos_inv_diag", "pos_info")}


def _plan(lib, tri, r: torch.Tensor, branch: str | None) -> tuple:
    call = (branch, r.dtype, r.get_device(), r.shape[0])
    entry = _plans.get(id(tri))
    if entry is not None and entry[0] == call:
        arrays = [getattr(tri, name) for name in _READS[entry[3][0]]]
        if (all(ref() is a for ref, a in zip(entry[1], arrays))
                and entry[2] == tuple(a._version for a in arrays)):
            return entry[3]
    code = _checked(tri, r)
    n, K = tri.num_rows, tri.ell_vals.shape[1]
    optin = _optin(lib, r.device.index)
    if branch is None:
        branch = t1_branch(n, tri.num_levels, K, r.dtype, optin)
    if branch not in BRANCHES:
        raise ValueError(f"unknown T1 branch {branch!r}; choose one of {BRANCHES}")
    launch = _Launch(vals=tri.ell_vals.data_ptr(), cols=tri.ell_cols.data_ptr(),
                     inv_diag=tri.inv_diag.data_ptr(), order=tri.order.data_ptr(),
                     row_len=tri.row_len.data_ptr(), n=n, K=K, dtype=code,
                     watchdog_s=WATCHDOG_S)
    kept = ()  # tensors the launch reads that the factor does not hold
    if branch == "grid":
        slots = grid_slots(K)
        rows, ptr = tri.strand_rows, tri.strand_ptr
        if ptr.device != r.device or ptr.dtype != torch.int32 or rows.shape != (n,):
            raise ValueError("T1 \"grid\" needs the factor's strands as build_triangular "
                             "makes them")
        room = _resident_warps(lib, r.device.index, code, slots)
        if ptr.numel() - 1 > room:
            rows, ptr = kept = round_robin_strands(tri.order, room)
        launch.slots, launch.strands = slots, ptr.numel() - 1
        launch.strand_rows, launch.strand_ptr = rows.data_ptr(), ptr.data_ptr()
    if branch == "block":
        g = block_geometry(K, r.dtype, optin)
        if g is None:
            raise ValueError(f"T1 \"block\" takes at most {BLOCK_MAX_K} slots a row in a ring "
                             f"of {optin} bytes; this factor has K = {K} of {r.dtype}")
        _checked_block(tri, r)
        launch.pos_vals, launch.pos_cols = tri.pos_vals.data_ptr(), tri.pos_cols.data_ptr()
        launch.pos_inv_diag, launch.pos_info = (tri.pos_inv_diag.data_ptr(),
                                                tri.pos_info.data_ptr())
        launch.n_pad, launch.S, launch.D, launch.W = (tri.pos_info.shape[0], g.chunk_rows,
                                                      g.stages, g.window)
    if len(_plans) >= _MAX_PLANS:
        _plans.clear()
    plan = (branch, n, launch, ctypes.addressof(launch), kept)
    arrays = [getattr(tri, name) for name in _READS[branch]]
    _plans[id(tri)] = (call, tuple(weakref.ref(a) for a in arrays),
                       tuple(a._version for a in arrays), plan)
    return plan


class _Slot:
    """Where one T1 solve leaves its two error words: mapped pinned host
    words ("block" writes them from the card, "grid"'s are copied there)
    and the event recorded behind them.  Made once, reused once read."""

    __slots__ = ("device", "host", "dev", "words", "event")

    def __init__(self, lib, index: int):
        self.device = index
        self.host, self.dev, self.event = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(index):
            _check(lib, lib.stormx_tri_host_words(ctypes.byref(self.host),
                                                  ctypes.byref(self.dev)), "tri_host_words")
            _check(lib, lib.stormx_tri_event_create(ctypes.byref(self.event)),
                   "tri_event_create")
        self.words = (ctypes.c_int32 * 2).from_address(self.host.value)


# Slots free for reuse, by device; list.pop and list.append are atomic, so
# ranks that are threads of one process may share them.
_free_slots: dict[int, list] = collections.defaultdict(list)
# T1 solves whose error words are not read yet, oldest first: (slot, n, lib).
_pending: collections.deque = collections.deque()


def _take_slot(lib, index: int) -> _Slot:
    try:
        return _free_slots[index].pop()
    except IndexError:
        return _Slot(lib, index)


def _read_errors(block: bool) -> None:
    """Read the error words of every ended T1 solve, oldest first (with
    ``block``, wait for all), and raise :class:`StormError` on the first
    that holds one."""
    while _pending:
        slot, n, lib = _pending[0]
        if block:
            _check(lib, lib.stormx_tri_event_sync(slot.event), "tri_event_sync")
        else:
            rc = lib.stormx_tri_event_query(slot.event)
            if rc == _NOT_READY:
                return
            _check(lib, rc, "tri_event_query")
        _pending.popleft()
        code, row = slot.words[0], slot.words[1]
        _free_slots[slot.device].append(slot)
        if code:
            raise StormError(f"tri_solve (T1): {_ERROR_MESSAGES.get(code, code)} at row {row} "
                             f"of {n}")


def check_watchdog() -> None:
    """Wait for every T1 solve launched so far and raise
    :class:`StormError` if any one met a corrupt factor."""
    _read_errors(block=True)


def exact_cuda(tri, r: torch.Tensor, *, branch: str | None = None) -> torch.Tensor:
    """Launch T1 on the current stream and return y without waiting.
    ``branch`` forces "block" or "grid" (measurement and tests); by default
    :func:`t1_branch` picks it from the factor's shape.  First raises
    :class:`StormError` if an earlier solve that has ended met a corrupt
    factor.  While a profiler records, the call is the span ``t1.launch``."""
    if not profiling.recording():
        return _exact_cuda(tri, r, branch)
    with profiling.annotate("t1.launch"):
        return _exact_cuda(tri, r, branch)


def _exact_cuda(tri, r: torch.Tensor, branch: str | None) -> torch.Tensor:
    from stormx_torch.ops import _cuda

    # A graph would replay the launch, not the slot, the event and the read
    # of earlier solves' error words: refuse before taking any.
    capture.refuse("T1 keeps host state between solves (error slots, events): it cannot run "
                   "inside a CUDA graph capture")
    _read_errors(block=False)
    if not r.is_cuda:
        raise ValueError("the tri_solve kernels need the factor and r on one CUDA device")
    lib = _cuda.library("tri_solve")
    branch, n, launch, address, _ = _plan(lib, tri, r, branch)
    if not r.is_contiguous() or r.data_ptr() % r.element_size():
        raise ValueError(f"r must be a contiguous ({n},) tensor aligned to its dtype")
    y = torch.empty_like(r)
    if n == 0:
        return y
    index = r.get_device()
    slot = _take_slot(lib, index)
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            rc = _launch_exact(lib, r, y, branch, n, launch, address, slot, index)
    else:
        rc = _launch_exact(lib, r, y, branch, n, launch, address, slot, index)
    if rc:
        _free_slots[index].append(slot)
        _check(lib, rc, f"tri_solve (T1 {branch})")
    _pending.append((slot, n, lib))
    launches["tri_exact"] += 1
    branch_launches[branch] += 1
    if branch == "grid":
        slot_launches[launch.slots] += 1
    return y


def _launch_exact(lib, r, y, branch, n, launch, address, slot, index) -> int:
    stream = torch._C._cuda_getCurrentRawStream(index)  # the current stream's handle
    if branch == "block":
        return lib.stormx_tri_exact_block(address, r.data_ptr(), y.data_ptr(), slot.dev,
                                          slot.event, stream)
    launch.watchdog_s = WATCHDOG_S
    scratch = torch.empty(scratch_words(n, r.dtype), dtype=torch.int32, device=r.device)
    return lib.stormx_tri_exact(address, r.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                                slot.host, slot.event, stream)


def sweep_cuda(tri, r: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Launch T2 ``sweeps`` times (``y0 = D⁻¹·r`` alone when ``sweeps`` is 0)."""
    from stormx_torch.ops import _cuda

    code = _checked(tri, r)
    if not r.is_contiguous():
        raise ValueError(f"r must be a contiguous ({tri.num_rows},) tensor")
    n, K = tri.ell_vals.shape[0] - 1, tri.ell_vals.shape[1]
    if sweeps == 0:
        return tri.inv_diag[:n] * r
    lib = _cuda.library("tri_solve")
    y = r  # not read by the first sweep
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(sweeps):
            y_new = torch.empty_like(r)
            rc = lib.stormx_tri_sweep(tri.ell_vals.data_ptr(), tri.ell_cols.data_ptr(),
                                      tri.inv_diag.data_ptr(), r.data_ptr(), y.data_ptr(),
                                      y_new.data_ptr(), n, K, code, int(s == 0), stream)
            _cuda.check(lib, rc, "tri_solve (T2)")
            launches["tri_sweep"] += 1
            y = y_new
    return y


def exact(tri, r: torch.Tensor) -> torch.Tensor:
    """The exact solve: T1 on the card, the plain version on the CPU."""
    if r.device.type == "cpu":
        return exact_plain(tri, r)
    return exact_cuda(tri, r.contiguous())


def sweep(tri, r: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` Jacobi sweeps: T2 on the card, the plain version on the CPU."""
    if r.device.type == "cpu":
        return sweep_plain(tri, r, sweeps)
    return sweep_cuda(tri, r.contiguous(), sweeps)


def l2_chase_ns(device, *, entries: int = 1 << 18, steps: int = 100_000, seed: int = 0) -> float:
    """The card's dependent L2 round trip in ns: one thread following a
    random cycle of ``entries`` int32 links (1 MB, inside L2) through L2,
    ``steps`` loads, timed with CUDA events after one warm-up pass.  A
    measurement probe for T1's latency bound; no path calls it."""
    from stormx_torch.ops import _cuda

    gen = torch.Generator(device="cpu").manual_seed(seed)
    perm = torch.randperm(entries, generator=gen)
    nxt = torch.empty(entries, dtype=torch.int32)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    nxt = nxt.to(device)
    out = torch.empty(1, dtype=torch.int32, device=device)
    lib = _cuda.library("tri_solve")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        for s in (entries, steps):  # the first pass warms L2
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rc = lib.stormx_l2_chase(nxt.data_ptr(), s, out.data_ptr(), stream.cuda_stream)
            end.record(stream)
            _cuda.check(lib, rc, "l2_chase")
        end.synchronize()
    return start.elapsed_time(end) * 1e6 / steps


def flag_hop_ns(device, *, hops: int = 100_000) -> tuple[float, list[int]]:
    """The hop of a flag between two SMs in ns, and the two SMs: two
    one-thread blocks pass a count back and forth through one word in
    global memory, each polling it (``ld.relaxed.gpu``) until it holds its
    turn and storing the next (``st.relaxed.gpu``), ``hops`` hops timed with
    CUDA events after one warm-up pass.  A measurement probe for T1
    "grid"'s hop a level; no path calls it."""
    from stormx_torch.ops import _cuda

    word = torch.empty(1, dtype=torch.int64, device=device)
    smid = torch.empty(2, dtype=torch.int32, device=device)
    lib = _cuda.library("tri_solve")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        for _ in range(2):  # the first pass warms the launch
            word.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rc = lib.stormx_flag_hop(word.data_ptr(), hops, smid.data_ptr(), stream.cuda_stream)
            end.record(stream)
            _check(lib, rc, "flag_hop")
        end.synchronize()
    if int(word.item()) != hops:
        raise RuntimeError(f"flag_hop_ns: the count reached {int(word.item())} of {hops}")
    return start.elapsed_time(end) * 1e6 / hops, smid.tolist()


def block_level_ns(device, *, levels: int = 100_000) -> float:
    """The hop from one level to the next inside one block, in ns: one
    block of 1,024 threads walks ``levels`` levels, at each one thread
    reading the value another warp wrote before the last barrier, timed
    with CUDA events after one warm-up pass.  A measurement probe for T1
    "block"'s latency bound; no path calls it."""
    from stormx_torch.ops import _cuda

    out = torch.empty(1, dtype=torch.int32, device=device)
    lib = _cuda.library("tri_solve")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        for _ in range(2):  # the first pass warms the launch
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rc = lib.stormx_tri_block_hop(levels, out.data_ptr(), stream.cuda_stream)
            end.record(stream)
            _check(lib, rc, "tri_block_hop")
        end.synchronize()
    if int(out.item()) != levels:
        raise RuntimeError(f"block_level_ns: the chain counted {int(out.item())} of {levels}")
    return start.elapsed_time(end) * 1e6 / levels
