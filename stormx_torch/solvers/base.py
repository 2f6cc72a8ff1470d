"""Shared iterative-solver driver (counterpart of ``stormx/solvers/base.py``).

The reference's template-method convergence loop
(``Solvers/Solver.hpp:116-147``), as a Python loop over tensors:

  1. ``init`` → initial residual norm; ``absolute_error = initial_error``.
  2. Pre-loop early exit: if ``atol > 0 and abs_err < atol`` the loop body
     never runs (zero iterations).
  3. Up to ``num_iterations`` iterations: ``iterate`` returns the residual
     norm; converged when ``(atol > 0 and abs < atol) or (rtol > 0 and
     rel < rtol)`` with ``rel = abs / initial``, compared in the error's
     dtype.
  4. ``finalize`` runs once after the loop, and is skipped when zero
     iterations ran (the JAX package's documented deviation from the
     reference).

The history is the ``(num_iterations + 1,)`` NaN-padded array of absolute
errors.  The eager loop's convergence test reads one boolean back to the
host per iteration (the ``lax.while_loop`` of the JAX package keeps it on
the device).

A solver whose iteration can be frozen by scalar means (``freezable``: CG)
runs on a CUDA device, after its first :data:`BLOCK_ITERATIONS` iterations
in the eager loop, as replays of a captured CUDA graph that holds
:data:`BLOCK_ITERATIONS` iterations, the nearest counterpart of the
``lax.while_loop``: the loop's state lives in device tensors made before
the capture, each iteration also updates a 0-dim ``done`` flag from the
same comparisons, and the host reads ``done`` and the count of frozen
iterations once a block (:func:`_run_blocks`).  An iteration that starts
after ``done`` runs frozen: it leaves x bit-unchanged, and its error is
not kept.  The result is the eager loop's, bit for bit.

The eager start is what lets the path adapt.  A solve that ends within it
(a short inner solve, a warm start) never pays a capture, which costs about
as much host time as one or two blocks run eagerly; a longer one pays it
once and then gains on every block.  And every layer of the iteration has run in it:
a layer that cannot be captured (``ops/capture.refuse``: T1, a nested
solve, the check modes) counts its calls there, and the solve then goes on
eagerly without trying a capture.  A refusal at capture time (raised by
such a layer, or a RuntimeError of an operation that a capture forbids,
such as a read of the device in an operator) ends and discards the capture,
and the solve goes on eagerly from the same state.  Nothing is remembered
between solves: the graph is captured once a solve and freed with it.
:data:`graph_stats` counts how the path went.

While a profiler session records, the loop opens spans
(:mod:`stormx_torch.core.profiling`): ``solver.solve`` around it all,
``solver.capture`` around a capture, ``solver.iterate`` around each
``iterate_fn`` call of the eager loop and each block (a replay), and
``solver.read`` around each blocking read of the device; otherwise it
opens none.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from stormx_torch.core import profiling
from stormx_torch.core.exceptions import CaptureRefusedError, StormError
from stormx_torch.ops import capture
from stormx_torch.solvers.preconditioner import PreconditionerSide

__all__ = ["SolverOptions", "SolveResult", "run_iterative", "resolve_side", "graph_stats",
           "BLOCK_ITERATIONS"]

# Iterations a captured graph holds: the host reads the device once a block
# (PERF.md §6: chosen from runs of 8, 16, 32 and 64 on an H100).
BLOCK_ITERATIONS = 16
# The graph path in this process: graphs captured, replays, solves that a
# layer's refusal kept eager (at its eager calls or at the capture),
# iterations run by replays and, of those, run frozen after the stop.  The
# share of iterations under replay is the path's hit share.
graph_stats = dict.fromkeys(("captures", "replays", "fallbacks", "iterations", "masked"), 0)
_streams: dict[int, torch.cuda.Stream] = {}  # by device: the side stream captures run on


@dataclass(frozen=True)
class SolverOptions:
    """Knobs with the reference's names and defaults (``Solver.hpp:66-76,158-159``)."""

    num_iterations: int = 2000
    absolute_tolerance: float = 1.0e-6
    relative_tolerance: float = 1.0e-6
    pre_side: PreconditionerSide | str = PreconditionerSide.RIGHT
    record_history: bool = True


class SolveResult(NamedTuple):
    x: torch.Tensor
    converged: bool
    num_iterations: int  # executed iteration count
    absolute_error: torch.Tensor
    relative_error: torch.Tensor
    history: torch.Tensor | None  # (num_iterations + 1,) abs errors, NaN padded


def resolve_side(side, *, precond=None, solver: str | None = None) -> PreconditionerSide:
    """Normalize ``pre_side``; reject the unimplemented SYMMETRIC side when a
    preconditioner is supplied (no solver implements a split M = M_L·M_R;
    CG, whose z = 𝓟r recurrence is the symmetric iteration for SPD 𝓟,
    does not call this)."""
    if not isinstance(side, PreconditionerSide):
        side = PreconditionerSide(str(side).lower())
    if side is PreconditionerSide.SYMMETRIC and precond is not None:
        raise StormError(
            f"pre_side='symmetric' is not implemented by {solver or 'this solver'}"
            " (a symmetric split M = M_L·M_R requires a factorized"
            " preconditioner); use 'left' or 'right' — or CG, whose z = 𝓟r"
            " recurrence is algebraically the symmetric-preconditioned"
            " iteration for SPD 𝓟"
        )
    return side


def run_iterative(
    init_fn: Callable,
    iterate_fn: Callable,
    finalize_fn: Callable | None,
    x0: torch.Tensor,
    options: SolverOptions,
    *,
    freezable: bool = False,
) -> SolveResult:
    """Drive ``iterate_fn`` to convergence.

    ``init_fn(x) -> (state, initial_error)``;
    ``iterate_fn(iteration, x, state) -> (x, state, abs_error)``;
    ``finalize_fn(executed_iterations, x, state) -> x`` (optional).

    ``freezable``: the state is a tuple of tensors, and ``iterate_fn`` also
    takes ``frozen=``, a 0-dim bool tensor on x's device; where it holds,
    the iteration leaves x bit-unchanged by scalar means and its state
    finite.  Called so, it reads nothing back to the host, and its
    ``iteration`` is None.  On a CUDA device the loop then goes on as graph
    replays after its eager start (the module's docstring).

    A solve reads the device, so no graph can replay one: called while the
    current CUDA stream captures (a solve inside another's captured
    iteration), it raises :class:`CaptureRefusedError`
    (``ops/capture.refuse``).
    """
    capture.refuse("a solve reads the device each iteration or block: it cannot run inside a "
                   "CUDA graph capture")
    if not profiling.recording():
        return _drive(init_fn, iterate_fn, finalize_fn, x0, options, freezable, traced=False)
    with profiling.annotate("solver.solve"):
        return _drive(init_fn, iterate_fn, finalize_fn, x0, options, freezable, traced=True)


def _spanned(name: str, fn: Callable) -> Callable:
    def call(*args):
        with profiling.annotate(name):
            return fn(*args)
    return call


def _span(name: str, traced: bool):
    return profiling.annotate(name) if traced else contextlib.nullcontext()


def _engages(x0: torch.Tensor) -> bool:
    """Whether a freezable solve runs as graph replays: on a CUDA device."""
    return x0.is_cuda


def _drive(init_fn, iterate_fn, finalize_fn, x0, options: SolverOptions, freezable: bool,
           traced: bool) -> SolveResult:
    """:func:`run_iterative`'s loop: the eager loop, which for a freezable
    solve on a card hands over to graph replays after its first block (the
    module's docstring) and takes back what is left of the solve after them
    or after a refusal."""
    read = _spanned("solver.read", bool) if traced else bool
    eager = _spanned("solver.iterate", iterate_fn) if traced else iterate_fn
    n_max, k = options.num_iterations, BLOCK_ITERATIONS
    state, initial_error = init_fn(x0)
    converged = bool(options.absolute_tolerance > 0.0
                     and read(initial_error < options.absolute_tolerance))
    errors = [initial_error]  # each iteration's error (a block's, when kept, as one tensor)
    run = (x0, state, initial_error, torch.ones_like(initial_error), 0, converged)
    graphs = freezable and _engages(x0)
    refusals = capture.refusals
    run = _loop(eager, run, errors, min(k, n_max) if graphs else n_max, options, read)
    it, converged = run[4:]
    if graphs and not converged and n_max - it >= k:
        if capture.refusals != refusals:
            graph_stats["fallbacks"] += 1
        else:
            try:
                run = _run_blocks(iterate_fn, run, errors, options, traced)
            except CaptureRefusedError:
                graph_stats["fallbacks"] += 1
    x, state, abs_err, rel_err, it, converged = _loop(eager, run, errors, n_max, options, read)

    if finalize_fn is not None and it > 0:
        x = finalize_fn(it, x, state)
    history = None
    if options.record_history:
        history = torch.full((n_max + 1,), math.nan, dtype=initial_error.dtype,
                             device=initial_error.device)
        history[: it + 1] = torch.cat([e.reshape(-1) for e in errors])
    return SolveResult(
        x=x,
        converged=converged,
        num_iterations=it,
        absolute_error=abs_err,
        relative_error=rel_err,
        history=history,
    )


def _loop(iterate_fn, run: tuple, errors: list, stop_at: int, options: SolverOptions,
          read: Callable) -> tuple:
    """The eager loop from ``run`` = (x, state, abs_err, rel_err, executed
    iterations, converged) until converged or ``stop_at`` iterations; each
    iteration's error is appended to ``errors`` and ``read`` turns a
    boolean tensor into a Python bool, waiting for the device.  Returns the
    new ``run``."""
    atol = options.absolute_tolerance
    rtol = options.relative_tolerance
    x, state, abs_err, rel_err, it, converged = run
    initial_error = errors[0]
    while not converged and it < stop_at:
        x, state, abs_err = iterate_fn(it, x, state)
        rel_err = abs_err / initial_error
        if atol > 0.0 and rtol > 0.0:
            converged = read((abs_err < atol) | (rel_err < rtol))  # one host sync
        elif atol > 0.0:
            converged = read(abs_err < atol)
        elif rtol > 0.0:
            converged = read(rel_err < rtol)
        errors.append(abs_err)
        it += 1
    return x, state, abs_err, rel_err, it, converged


def _stop_test(atol: float, rtol: float, initial_error: torch.Tensor) -> Callable | None:
    """The eager loop's convergence test as a function of an iteration's
    error, on the limits held as device scalars of the error's dtype (the
    eager loop compares in that dtype too); None for no tolerance."""
    def limit(value):
        return torch.full((), value, dtype=initial_error.dtype, device=initial_error.device)

    atol_t, rtol_t = limit(atol), limit(rtol)
    if atol > 0.0 and rtol > 0.0:
        return lambda err: (err < atol_t) | (err / initial_error < rtol_t)
    if atol > 0.0:
        return lambda err: err < atol_t
    if rtol > 0.0:
        return lambda err: err / initial_error < rtol_t
    return None


def _refuse_unlike(got: torch.Tensor, want: torch.Tensor) -> None:
    """Refuse a block whose iteration changes a tensor of the loop's state
    in shape, dtype or device: the graph reads and writes fixed tensors.
    (CG's x, which turns float64 from a float32 x0 and a float64 b, has
    turned in the eager start.)"""
    if got.shape != want.shape or got.dtype != want.dtype or got.device != want.device:
        raise CaptureRefusedError("an iteration changes the shape, dtype or device of the "
                                  "loop's state")


def _run_blocks(iterate_fn, run: tuple, errors: list, options: SolverOptions,
                traced: bool) -> tuple:
    """The loop from ``run`` (as :func:`_loop` takes it) in blocks of
    :data:`BLOCK_ITERATIONS` iterations while a whole block fits under
    ``num_iterations``, each a replay of one captured graph followed by one
    read of (done, frozen iterations so far); the errors of a block, when
    the history is kept, are appended to ``errors`` as one tensor.  Returns
    the new ``run``, as :func:`_loop` would have, bit for bit.  ``run``'s
    tensors are left as they are, so a refused capture can go on eagerly
    from them.  Off a card (the CPU tests) each block runs without capture."""
    x0, state, _, _, it, _ = run
    n_max, k = options.num_iterations, BLOCK_ITERATIONS
    dev = x0.device
    e0 = errors[0]
    x_s = x0.clone()
    state_s = tuple(t.clone() for t in state)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    flags = torch.zeros(2, dtype=torch.int64, device=dev)  # (done, frozen so far): one read
    n_frozen = flags[1]
    errs = torch.empty(k, dtype=e0.dtype, device=dev)  # the block's errors, by iteration
    stop = _stop_test(options.absolute_tolerance, options.relative_tolerance, e0)

    def block() -> None:
        x, st = x_s, state_s
        for j in range(k):
            x, st, err = iterate_fn(None, x, st, frozen=done)
            _refuse_unlike(err, e0)
            errs[j].copy_(err)
            n_frozen.add_(done)
            if stop is not None:
                torch.logical_or(done, stop(err), out=done)
        for new, static in zip((x, *st), (x_s, *state_s), strict=True):
            _refuse_unlike(new, static)
        for new, static in zip((x, *st), (x_s, *state_s)):
            static.copy_(new)
        flags[0].copy_(done)

    graph, counts = None, []
    if dev.type == "cuda":
        with _span("solver.capture", traced):
            graph, counts = _capture(block, dev)
    read = _spanned("solver.read", torch.Tensor.tolist) if traced else torch.Tensor.tolist
    frozen_seen = 0
    converged = False
    while not converged and n_max - it >= k:
        with _span("solver.iterate", traced):
            if graph is not None:
                with torch.cuda.device(dev):
                    graph.replay()
                capture.add(counts)
            else:
                block()
        ran = k
        if stop is not None:
            converged, frozen_now = read(flags)
            converged = bool(converged)
            ran -= frozen_now - frozen_seen
            frozen_seen = frozen_now
        if graph is not None:
            graph_stats["replays"] += 1
            graph_stats["iterations"] += ran
            graph_stats["masked"] += k - ran
        if options.record_history:
            errors.append(errs[:ran].clone())
        it += ran

    abs_err = errs[ran - 1].clone()
    return x_s, state_s, abs_err, abs_err / e0, it, converged


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    stream = _streams.get(dev.index)
    if stream is None:
        stream = _streams[dev.index] = torch.cuda.Stream(dev)
        # cuBLAS makes a workspace at its first call on a stream: make it
        # outside any capture, so that no graph's memory holds it.
        with torch.cuda.stream(stream):
            one = torch.ones(1, device=dev)
            torch.vdot(one, one)
        stream.synchronize()
    return stream


def _capture(block: Callable, dev: torch.device):
    """``block()`` captured into a CUDA graph on a side stream: the graph and
    the launch counts it holds (:mod:`stormx_torch.ops.capture`), which the
    capture itself leaves uncounted.  A refusal, or a RuntimeError of an
    operation the capture forbids, ends the capture and discards it, and
    :class:`CaptureRefusedError` propagates."""
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()  # a pool of its own, as by default, but named
    stream = _capture_stream(dev)
    before = capture.snapshot()
    try:
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                block()
            except BaseException as exc:
                _discard(graph, pool, dev)
                if isinstance(exc, RuntimeError):
                    raise CaptureRefusedError(f"the capture failed: {exc}") from exc
                raise
            graph.capture_end()
    finally:
        counts = capture.take_back(before)
    graph_stats["captures"] += 1
    return graph, counts


def _discard(graph: torch.cuda.CUDAGraph, pool: tuple, dev: torch.device) -> None:
    """End a capture that a refusal or an error cut short, and free what it
    holds.  An operation that the capture forbids invalidates it, and
    ``capture_end`` then raises before it stops sending the stream's
    allocations to the graph's memory pool, which the graph then never
    frees: do both here."""
    try:
        graph.capture_end()
        ended = True
    except RuntimeError:
        ended = False
        with contextlib.suppress(RuntimeError):
            torch._C._cuda_endAllocateToPool(dev.index, pool)
    with contextlib.suppress(RuntimeError):
        graph.reset()
    if not ended:
        with contextlib.suppress(RuntimeError):
            torch._C._cuda_releasePool(dev.index, pool)
