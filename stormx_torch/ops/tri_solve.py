"""T1 and T2: the sparse triangular solve's kernels (``csrc/tri_solve.cu``)
and their plain versions, for :func:`stormx_torch.precond.tri_solve`.

They stand for the JAX package's level loop (an XLA program,
``stormx/precond/triangular.py:146-175``), not for a Pallas kernel:

* T1, :func:`exact_cuda`: the exact solve ``(D + N)·y = r`` in one
  cooperative launch, one warp a row, each row waiting on the ready flags of
  its own dependencies (no barrier per level), behind a memset of the
  solve's own flag words.  The host does not wait for it.  A wait longer
  than ``WATCHDOG_S`` on one row, or a column outside ``[0, n)``, ends the
  launch with NaN in the rows it could not solve and raises
  :class:`StormError` at the next T1 call that finds the solve ended, or at
  :func:`check_watchdog`, which waits for every solve launched.
* T2, :func:`sweep_cuda`: ``sweeps`` Jacobi sweeps ``y ← D⁻¹(r − N·y)``,
  one launch a sweep, the first forming ``y0 = D⁻¹·r`` inline.

The plain versions (:func:`exact_plain`, :func:`sweep_plain`) add each
row's ELL slots in slot order, one rounded multiply and one rounded add a
slot (:func:`slot_sum`), and the kernels do the same, so in float32 and
float64 they agree bit for bit wherever y is finite (T1 skips the padding
slots, which the plain version adds as ±0·y[0]).  Complex products are
written out in the kernels in one order; they agree with the plain
versions to a few ulps.  The public functions launch the kernel for
tensors on the card and take the plain version only for tensors on the
CPU.
"""

from __future__ import annotations

import collections

import torch

from stormx_torch.core.exceptions import StormError

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
    "WATCHDOG_S",
]

# Kernel launches of this process, by kernel; only the *_cuda functions add to them.
launches = {"tri_exact": 0, "tri_sweep": 0}
# Seconds one warp of T1 may wait on one row's dependencies.  A legitimate
# wait is bounded by the positions in flight (~8,400 warps, ~1 µs a level);
# passing it means the factor's order or columns are corrupt.
WATCHDOG_S = 2.0
SCRATCH_HEADER = 4  # words before T1's ready flags (csrc/tri_solve.cu, Header)
_ERROR_WORDS = slice(1, 3)  # the watchdog's error code and row (kErrCode, kErrRow)
_WATCHDOG_ERRORS = {1: "a wait on its dependencies passed the watchdog",
                    2: "a column lies outside [0, n)"}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}


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
    if r.shape != (n,) or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous ({n},) tensor, got {tuple(r.shape)}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("the factor's tensors must be contiguous")
    return _DTYPES[r.dtype]


def scratch_words(n: int, dtype: torch.dtype) -> int:
    """32-bit words of one T1 solve's scratch for n rows of ``dtype``: the
    header and, a row, itemsize/4 flag words of 64 bits (stamp and 32 bits
    of y)."""
    return SCRATCH_HEADER + 2 * n * (dtype.itemsize // 4)


# T1 solves whose error words are not read yet: (an event recorded behind
# the copy of the words, the words in pinned host memory, n).
_pending: collections.deque = collections.deque()


def _read_errors(block: bool) -> None:
    """Read the error words of every ended T1 solve, oldest first (with
    ``block``, wait for all), and raise :class:`StormError` on the first
    that holds one."""
    while _pending:
        event, words, n = _pending[0]
        if not block and not event.query():
            return
        event.synchronize()
        _pending.popleft()
        code, row = words.tolist()
        if code:
            raise StormError(f"tri_solve (T1): {_WATCHDOG_ERRORS.get(code, code)} at row {row} "
                             f"of {n}")


def check_watchdog() -> None:
    """Wait for every T1 solve launched so far and raise
    :class:`StormError` if the watchdog of any one fired."""
    _read_errors(block=True)


def exact_cuda(tri, r: torch.Tensor) -> torch.Tensor:
    """Launch T1 on the current stream and return y without waiting.  First
    raises :class:`StormError` if an earlier solve that has ended met the
    watchdog."""
    from stormx_torch.ops import _cuda

    _read_errors(block=False)
    code = _checked(tri, r)
    n, K = tri.ell_vals.shape[0] - 1, tri.ell_vals.shape[1]
    y = torch.empty_like(r)
    scratch = torch.empty(scratch_words(n, r.dtype), dtype=torch.int32, device=r.device)
    lib = _cuda.library("tri_solve")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream()
        rc = lib.stormx_tri_exact(tri.ell_vals.data_ptr(), tri.ell_cols.data_ptr(),
                                  tri.inv_diag.data_ptr(), r.data_ptr(), tri.order.data_ptr(),
                                  tri.row_len.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                                  n, K, code, WATCHDOG_S, stream.cuda_stream)
        _cuda.check(lib, rc, "tri_solve (T1)")
        words = torch.empty(2, dtype=torch.int32, pin_memory=True)
        words.copy_(scratch[_ERROR_WORDS], non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    _pending.append((event, words, n))
    launches["tri_exact"] += 1
    return y


def sweep_cuda(tri, r: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Launch T2 ``sweeps`` times (``y0 = D⁻¹·r`` alone when ``sweeps`` is 0)."""
    from stormx_torch.ops import _cuda

    code = _checked(tri, r)
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
