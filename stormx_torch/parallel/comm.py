"""Ranks and collectives of the distributed layer: the port's counterpart of
``shard_map``'s mesh axis (``stormx/parallel/sharded.py:AXIS``).

The JAX package runs a whole solve inside one ``shard_map`` region, and its
reductions and halo exchanges name the mesh axis.  The port runs one Python
process (or thread) per rank on ``torch.distributed``; :func:`make_device_mesh`
returns this rank's handle, a :class:`RankMesh`, and that handle is what
every ``axis_name`` argument of the solvers and of ``ops/vector.py`` takes.
It offers the three collectives the JAX layer uses:

* :meth:`RankMesh.all_reduce_sum` (and ``_max``) for ``lax.psum``;
* :meth:`RankMesh.all_gather` for ``lax.all_gather``;
* :meth:`RankMesh.exchange` for the two neighbour ``lax.ppermute`` shifts
  of the banded and sliced halos; a missing neighbour gives zeros, as
  ``ppermute`` does.

The backend is the caller's choice and is never swapped behind its back:

* ``nccl`` (``torchrun --nproc-per-node=N``, one rank per card): the
  collectives are NCCL launches on the card.  NCCL refuses two ranks on one
  card, so asking it for more local ranks than cards raises ``StormError``.
* ``gloo``: CPU ranks (the tests), or ranks that share one card.  Gloo moves
  bytes through host memory, so for tensors on the card the handle copies
  each operand to the host, runs the collective there and copies the result
  back.  That staging is deliberate and applies to every gloo collective on
  the card, send/recv included.

:func:`run_thread_ranks` runs P ranks as threads of one process, each with
its own gloo group over a shared in-memory store: the CPU tests use it.
:class:`RankPool` runs P ranks as processes of their own, kept alive across
jobs, over gloo with a file store: ranks that share one card run so, since
threads that launch into one CUDA context serialize on it
(``scripts/torch_rank_probe.py`` times both arrangements; PERF.md has its
numbers).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from collections import Counter

import torch
import torch.distributed as dist

from stormx_torch.core.config import resolve_device
from stormx_torch.core.exceptions import StormError

__all__ = ["RankMesh", "make_device_mesh", "run_thread_ranks", "RankPool"]


def _backend_of(group) -> str:
    try:
        return str(dist.get_backend(group)).lower()
    except (RuntimeError, ValueError, AttributeError):
        return str(group.name()).lower()  # a group made outside the c10d registry


class _Pending:
    """A collective in flight: :meth:`wait` finishes it and returns its
    result."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self):
        return self._finish()


class RankMesh:
    """This rank's handle: process group, rank, size and device.

    ``calls`` counts the collectives this rank issued, by kind
    (``"all_reduce"``, ``"all_gather"``, ``"exchange"``), and ``moved`` the
    bytes this rank received from other ranks' operands, by the same kinds:
    (P − 1) copies of the operand for an all-reduce or an all-gather, the
    live halos of an exchange.  Summed over the ranks, one product's
    ``moved`` is what ``stormx_torch.parallel.commvol`` reports for its
    layout.  Callers reset them with ``calls.clear()`` and
    ``moved.clear()``.
    """

    def __init__(self, group, device, backend: str | None = None):
        self.group = group
        self.rank = int(group.rank())
        self.size = int(group.size())
        self.device = torch.device(device)
        self.backend = backend or _backend_of(group)
        # Gloo on the card: stage every operand through the host (see the
        # module docstring).
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        self.calls: Counter = Counter()
        self.moved: Counter = Counter()

    def __repr__(self):
        return (f"RankMesh(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")

    # -- staging ---------------------------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.stage else t

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if self.stage else t

    # -- reductions --------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        self.calls["all_reduce"] += 1
        self.moved["all_reduce"] += (self.size - 1) * t.numel() * t.element_size()
        shape = t.shape
        buf = self._out(t).reshape(-1).clone()
        flat = torch.view_as_real(buf) if buf.is_complex() else buf
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        self.group.allreduce([flat], opts).wait()
        return self._back(buf, t).reshape(shape)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks (``lax.psum``); every rank gets the same bits."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """max over the ranks (``lax.pmax``), for real tensors."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    # -- gathers and shifts --------------------------------------------------
    def all_gather(self, t: torch.Tensor, *, async_op: bool = False):
        """(P, *t.shape): every rank's ``t`` in rank order
        (``lax.all_gather``).  With ``async_op`` it returns a handle whose
        ``wait()`` gives the result, so work can run while it is in flight."""
        self.calls["all_gather"] += 1
        self.moved["all_gather"] += (self.size - 1) * t.numel() * t.element_size()
        src = self._out(t).contiguous()
        outs = [torch.empty_like(src) for _ in range(self.size)]
        work = self.group.allgather([outs], [src])

        def finish():
            work.wait()
            return self._back(torch.stack(outs), t)

        pending = _Pending(finish)
        return pending if async_op else pending.wait()

    def exchange(self, to_next: torch.Tensor | None, to_prev: torch.Tensor | None, *,
                 async_op: bool = False):
        """The two neighbour shifts of a slab halo, both in flight at once.

        Rank r sends ``to_next`` to rank r+1 and ``to_prev`` to rank r−1, and
        gets ``(from_prev, from_next)``: what rank r−1 sent forward and what
        rank r+1 sent back.  A missing neighbour (rank 0's previous, the
        last rank's next) gives zeros, as ``lax.ppermute`` does; a ``None``
        operand is a halo of width 0 and gives ``None``.  With ``async_op``
        it returns a handle whose ``wait()`` gives the pair.
        """
        self.calls["exchange"] += 1
        r, p = self.rank, self.size
        from_prev = None if to_next is None else torch.zeros_like(self._out(to_next))
        from_next = None if to_prev is None else torch.zeros_like(self._out(to_prev))
        # (send?, peer, buffer, tag) per live link; tag 0 carries forward
        # traffic and tag 1 backward, so the two never cross.
        links = []
        if to_next is not None:
            if r + 1 < p:
                links.append((True, r + 1, self._out(to_next).contiguous(), 0))
            if r > 0:
                links.append((False, r - 1, from_prev, 0))
        if to_prev is not None:
            if r > 0:
                links.append((True, r - 1, self._out(to_prev).contiguous(), 1))
            if r + 1 < p:
                links.append((False, r + 1, from_next, 1))
        self.moved["exchange"] += sum(buf.numel() * buf.element_size()
                                      for send, _, buf, _ in links if not send)
        if not links:
            works = []
        elif self.backend == "nccl":
            # NCCL pairs point-to-point calls only inside one group call.
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend if send else dist.irecv, buf, peer,
                           group=self.group, tag=tag)
                for send, peer, buf, tag in links])
        else:
            works = [(self.group.send if send else self.group.recv)([buf], peer, tag)
                     for send, peer, buf, tag in links]

        def finish():
            for work in works:
                work.wait()
            return (None if to_next is None else self._back(from_prev, to_next),
                    None if to_prev is None else self._back(from_next, to_prev))

        pending = _Pending(finish)
        return pending if async_op else pending.wait()

def make_device_mesh(num_parts: int | None = None, *, group=None, device=None) -> RankMesh:
    """This rank's :class:`RankMesh`.

    ``group`` defaults to the default process group that ``torchrun`` or
    ``torch.distributed.init_process_group`` made; ``num_parts``, when
    given, must equal its size.  ``device`` defaults to the card
    ``cuda:{LOCAL_RANK % device_count}`` and raises ``StormError`` where
    there is none: the CPU comes only when asked for.  An NCCL group with
    more ranks on this host than cards raises too.
    """
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise StormError(
                "no process group: call torch.distributed.init_process_group "
                "(or run under torchrun), or pass group="
            )
        group = dist.distributed_c10d._get_default_group()
    size = int(group.size())
    if num_parts is not None and num_parts != size:
        raise StormError(f"the process group has {size} ranks, not num_parts={num_parts}")
    backend = _backend_of(group)
    if device is None:
        resolve_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", group.rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise StormError("the nccl backend needs a CUDA device")
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        if local_size > torch.cuda.device_count():
            raise StormError(
                f"nccl takes one rank per card: {local_size} ranks on this host, "
                f"{torch.cuda.device_count()} card(s); run ranks that share a card "
                "over gloo (run_thread_ranks)"
            )
    return RankMesh(group, device, backend)


def _gloo_group(store, rank: int, size: int, timeout: float):
    """A gloo group of its own, on the loopback interface."""
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(store, rank, size, opts)


def run_thread_ranks(num_parts: int, fn, *, device="cuda", timeout: float = 60.0) -> list:
    """Run ``fn(mesh)`` on ``num_parts`` ranks, each a thread of this process
    with its own gloo group over one in-memory store; returns the ranks'
    results in rank order.

    ``device`` is every rank's device (the card unless the caller asks for
    the CPU; ranks on one card share it and its default stream).  Each
    collective waits at most ``timeout`` seconds, so ranks that part ways
    fail instead of hanging; the first exception a rank raised is raised
    again here, and ranks still running after twice ``timeout`` raise
    ``StormError``.
    """
    device = _indexed(resolve_device(device))
    store = dist.HashStore()
    results = [None] * num_parts
    errors: list = []

    def body(rank):
        try:
            group = _gloo_group(store, rank, num_parts, timeout)
            if device.type == "cuda":
                torch.cuda.set_device(device)
            results[rank] = fn(RankMesh(group, device, "gloo"))
        except BaseException as e:  # handed to the caller below
            errors.append((time.monotonic(), rank, e))

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"stormx-rank-{r}") for r in range(num_parts)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 2 * timeout
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    if errors:
        raise min(errors, key=lambda e: e[0])[2]
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise StormError(f"{alive} did not finish within {2 * timeout:.0f} s")
    return results


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _rank_main(rank, size, store_path, device, timeout, jobs, results):
    """A rank process of :class:`RankPool`: one gloo group, then jobs until
    ``None``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = RankMesh(_gloo_group(dist.FileStore(store_path, size), rank, size, timeout),
                      device, "gloo")
    while (job := jobs.get()) is not None:
        fn, args = job
        try:
            results.put((rank, True, fn(mesh, *args)))
        except BaseException:  # handed to the parent with its traceback
            results.put((rank, False, traceback.format_exc()))


class RankPool:
    """``num_parts`` ranks as processes of their own (``spawn``), each with
    one gloo group over a file store in a temporary directory, kept alive
    across jobs.  ``run(fn, *args)`` calls ``fn(mesh, *args)`` on every rank
    and returns the results in rank order.

    ``fn`` and ``args`` are pickled to the ranks and the results back, so
    ``fn`` is a module-level function and results should be host values.
    Each collective waits at most ``timeout`` seconds; a job that raises on
    any rank raises ``StormError`` with the traceback of the rank whose
    failure came back first (the others' are often timeouts waiting for
    it), and so do
    ranks that return nothing within twice ``timeout``.  Use it as a context
    manager (or call :meth:`close`), which stops every rank.
    """

    def __init__(self, num_parts: int, *, device="cuda", timeout: float = 60.0):
        import torch.multiprocessing as mp

        device = _indexed(resolve_device(device))
        self.num_parts, self.timeout = num_parts, timeout
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="stormx-ranks-")
        self._jobs = [ctx.Queue() for _ in range(num_parts)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, num_parts, os.path.join(self._dir, "store"), str(device), timeout,
            self._jobs[r], self._results)) for r in range(num_parts)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args) -> list:
        for q in self._jobs:
            q.put((fn, args))
        out, failed = [None] * self.num_parts, []
        for _ in range(self.num_parts):
            try:
                rank, ok, value = self._results.get(timeout=2 * self.timeout)
            except queue.Empty:
                raise StormError(
                    f"a rank returned nothing within {2 * self.timeout:.0f} s") from None
            if ok:
                out[rank] = value
            else:
                failed.append((rank, value))
        if failed:  # the first to arrive; the others may be its victims' timeouts
            rank, tb = failed[0]
            raise StormError(f"rank {rank} of the pool raised:\n{tb}")
        return out

    def close(self) -> None:
        for q, p in zip(self._jobs, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(self.timeout)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
