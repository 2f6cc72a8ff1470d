"""T1 and T2: the sparse triangular solve's kernels (``csrc/tri_solve.cu``)
and their plain versions, for :func:`stormx_torch.precond.tri_solve`.

They stand for the JAX package's level loop (an XLA program,
``stormx/precond/triangular.py:146-175``), not for a Pallas kernel:

* T1, :func:`exact_cuda`: the exact solve ``(D + N)·y = r`` in one
  cooperative launch, a warp for every strand of the factor
  (``precond.triangular.strands``: chains of rows each reading the one
  before it, as many strands as the widest level has rows), its lanes
  holding the strand's next 32 rows (:func:`grid_slots` slots each at once)
  and polling the ready flags of their dependencies in other strands (no
  barrier per level), the strand's rows solved in turn with the link's y
  passed by shuffle, behind a memset of the solve's own flag words.  A wait
  longer than ``WATCHDOG_S`` on one row, or a column outside ``[0, n)``,
  ends the launch with NaN in the rows it could not solve.

  The host does not wait for it: each launch copies its two error words
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
versions to a few ulps.  The public functions launch the kernel for
tensors on the card and take the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import weakref

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
    "grid_slots",
    "round_robin_strands",
    "WATCHDOG_S",
]

# Kernel launches of this process, by kernel; only the *_cuda functions add to them.
launches = {"tri_exact": 0, "tri_sweep": 0}
# T1's slots a lane at once built (csrc/tri_solve.cu, exact_slots).
GRID_SLOTS = (1, 2, 4, 8)
# T1's launches again, by the slots a lane holds at once (grid_slots)
slot_launches = dict.fromkeys(GRID_SLOTS, 0)
# Seconds one lane of T1 may wait on one row's dependencies.  A
# legitimate wait is bounded by the strand's rows ahead of it (32, under
# 1 µs a level); passing it means the factor's strands or columns are
# corrupt.
WATCHDOG_S = 2.0
SCRATCH_HEADER = 4  # words before T1's ready flags (csrc/tri_solve.cu, Header)
_ERROR_MESSAGES = {1: "a wait on its dependencies passed the watchdog",
                   2: "a column lies outside [0, n)"}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}
_NOT_READY = 600  # cudaErrorNotReady

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


# -- T1's geometry (host only) ------------------------------------------------


def grid_slots(K: int) -> int:
    """T1's slots a lane holds at once for rows of K slots: the power of two
    at or above K, at most 8 (a row of more takes passes of 8)."""
    return min(GRID_SLOTS[-1], 1 << (max(K, 1) - 1).bit_length())


def round_robin_strands(order: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``count`` strands of the rows in level order: strand s the rows
    ``order[s], order[s + count], ...``, so each strand's levels increase.
    T1's strands where a factor's own (one a row of its widest level)
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


def scratch_words(n: int, dtype: torch.dtype) -> int:
    """32-bit words of one T1 solve's scratch for n rows of
    ``dtype``: the header and, a row, itemsize/4 flag words of 64 bits
    (stamp and 32 bits of y)."""
    return SCRATCH_HEADER + 2 * n * (dtype.itemsize // 4)


_grid_warps: dict[tuple, int] = {}  # (device, dtype code, S) -> T1 warps resident


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
    csrc/tri_solve.cu): the arrays T1 reads and the shape."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "vals", "cols", "inv_diag", "row_len")] + [
        (name, ctypes.c_int) for name in ("n", "K", "dtype")] + [
        ("watchdog_s", ctypes.c_double)] + [
        (name, ctypes.c_int) for name in ("slots", "strands")] + [
        (name, ctypes.c_void_p) for name in ("strand_rows", "strand_ptr")]


# What a launch decides from a factor, checked and packed once: id(factor)
# -> (the call: r's dtype, device and length; weak references to the
# tensors T1 reads; their versions; the plan: n, the _Launch and its
# address).  A hit needs the same tensor objects at the same versions.
_plans: dict[int, tuple] = {}
_MAX_PLANS = 512
_READS = ("ell_vals", "ell_cols", "inv_diag", "row_len", "strand_rows", "strand_ptr")


def _plan(lib, tri, r: torch.Tensor) -> tuple:
    call = (r.dtype, r.get_device(), r.shape[0])
    entry = _plans.get(id(tri))
    arrays = [getattr(tri, name) for name in _READS]
    if (entry is not None and entry[0] == call
            and all(ref() is a for ref, a in zip(entry[1], arrays))
            and entry[2] == tuple(a._version for a in arrays)):
        return entry[3]
    code = _checked(tri, r)
    n, K = tri.num_rows, tri.ell_vals.shape[1]
    slots = grid_slots(K)
    rows, ptr = tri.strand_rows, tri.strand_ptr
    if ptr.device != r.device or ptr.dtype != torch.int32 or rows.shape != (n,):
        raise ValueError("T1 needs the factor's strands as build_triangular makes them")
    kept = ()  # tensors the launch reads that the factor does not hold
    room = _resident_warps(lib, r.device.index, code, slots)
    if ptr.numel() - 1 > room:
        rows, ptr = kept = round_robin_strands(tri.order, room)
    launch = _Launch(vals=tri.ell_vals.data_ptr(), cols=tri.ell_cols.data_ptr(),
                     inv_diag=tri.inv_diag.data_ptr(), row_len=tri.row_len.data_ptr(), n=n,
                     K=K, dtype=code, watchdog_s=WATCHDOG_S, slots=slots,
                     strands=ptr.numel() - 1, strand_rows=rows.data_ptr(),
                     strand_ptr=ptr.data_ptr())
    if len(_plans) >= _MAX_PLANS:
        _plans.clear()
    plan = (n, launch, ctypes.addressof(launch), kept)
    _plans[id(tri)] = (call, tuple(weakref.ref(a) for a in arrays),
                       tuple(a._version for a in arrays), plan)
    return plan


class _Slot:
    """Where one T1 solve leaves its two error words: pinned host words,
    copied there behind the launch, and the event recorded behind them.
    Made once, reused once read."""

    __slots__ = ("device", "host", "words", "event")

    def __init__(self, lib, index: int):
        self.device = index
        self.host, self.event = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(index):
            _check(lib, lib.stormx_tri_host_words(ctypes.byref(self.host)), "tri_host_words")
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


def exact_cuda(tri, r: torch.Tensor) -> torch.Tensor:
    """Launch T1 on the current stream and return y without waiting.  First
    raises :class:`StormError` if an earlier solve that has ended met a
    corrupt factor.  While a profiler records, the call is the span
    ``t1.launch``."""
    if not profiling.recording():
        return _exact_cuda(tri, r)
    with profiling.annotate("t1.launch"):
        return _exact_cuda(tri, r)


def _exact_cuda(tri, r: torch.Tensor) -> torch.Tensor:
    from stormx_torch.ops import _cuda

    # A graph would replay the launch, not the slot, the event and the read
    # of earlier solves' error words: refuse before taking any.
    capture.refuse("T1 keeps host state between solves (error slots, events): it cannot run "
                   "inside a CUDA graph capture")
    _read_errors(block=False)
    if not r.is_cuda:
        raise ValueError("the tri_solve kernels need the factor and r on one CUDA device")
    lib = _cuda.library("tri_solve")
    n, launch, address, _ = _plan(lib, tri, r)
    if not r.is_contiguous() or r.data_ptr() % r.element_size():
        raise ValueError(f"r must be a contiguous ({n},) tensor aligned to its dtype")
    y = torch.empty_like(r)
    if n == 0:
        return y
    index = r.get_device()
    slot = _take_slot(lib, index)
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            rc = _launch_exact(lib, r, y, n, launch, address, slot, index)
    else:
        rc = _launch_exact(lib, r, y, n, launch, address, slot, index)
    if rc:
        _free_slots[index].append(slot)
        _check(lib, rc, "tri_solve (T1)")
    _pending.append((slot, n, lib))
    launches["tri_exact"] += 1
    slot_launches[launch.slots] += 1
    return y


def _launch_exact(lib, r, y, n, launch, address, slot, index) -> int:
    stream = torch._C._cuda_getCurrentRawStream(index)  # the current stream's handle
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
    CUDA events after one warm-up pass.  A measurement probe for T1's hop
    a level; no path calls it."""
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

