"""Distributed banded (DIA) operators with neighbour halo shifts
(counterpart of ``stormx/parallel/banded.py``).

For a banded operator a row-block partition needs only the band edges of its
two NEIGHBOUR blocks — h = max|offset| values each way — so the halo is two
neighbour shifts (``RankMesh.exchange``), not an all-gather:

    per CG iteration: 1 exchange (both shifts) + 2 all-reduces (dots),
    everything else rank-local elementwise streams.

The outer ranks receive zeros from the missing neighbour, which is exactly
right because out-of-band DIA entries are zero.  The slab product is plain
torch, as the JAX package's is XLA slices and no Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.sparse.formats import host

__all__ = ["PartitionedDIA", "partition_dia", "sharded_dia_solve"]


@dataclass(frozen=True)
class PartitionedDIA:
    """A DIA operator split into P contiguous row blocks.

    ``data``: (P, num_diags, n_loc); ``offsets`` static.  Halo width
    ``h = max|offset|`` must satisfy ``h <= n_loc`` (one neighbour each way).
    """

    num_parts: int
    n_global: int
    n_loc: int
    h: int
    offsets: tuple[int, ...]
    data: torch.Tensor

    def local_matvec(self, axis_name, *, overlap: bool = True):
        """Rank-local banded product ``x_loc (n_loc,) → (n_loc,)`` for the
        rank of ``axis_name`` (its mesh handle), with that rank's diagonals
        bound on its device.

        ``overlap=True`` (default, needs ``n_loc >= 2h``): the halo shifts
        are started first, the interior rows [h, n_loc−h) — whose band
        stays inside the local block — are computed from ``x_loc`` alone
        while they are in flight, and only the h-row head and tail strips
        read the halos.  Per-row sums keep the same diagonal order, so the
        result is bit-identical to the unoverlapped path.
        """
        mesh = axis_name
        h, n_loc, offsets = self.h, self.n_loc, self.offsets
        data = self.data[mesh.rank].to(mesh.device)
        if h == 0:
            def matvec_local(x_loc):
                y = torch.zeros_like(x_loc)
                for d, _ in enumerate(offsets):
                    y = y + data[d] * x_loc
                return y

            return matvec_local

        def shifts(x_loc, async_op=False):
            # My tail → next rank's left halo; my head → previous rank's
            # right halo.  Missing neighbours zero-fill.
            return mesh.exchange(x_loc[-h:], x_loc[:h], async_op=async_op)

        if not overlap or n_loc < 2 * h:
            def matvec(x_loc):
                left, right = shifts(x_loc)
                x_ext = torch.cat([left, x_loc, right])
                y = torch.zeros_like(x_loc)
                for d, off in enumerate(offsets):
                    y = y + data[d] * x_ext[h + off : h + off + n_loc]
                return y

            return matvec

        def matvec(x_loc):
            pending = shifts(x_loc, async_op=True)  # started before the interior
            # Interior rows i ∈ [h, n_loc−h): x_loc[i+off] stays in range.
            y_mid = torch.zeros(n_loc - 2 * h, dtype=x_loc.dtype, device=x_loc.device)
            for d, off in enumerate(offsets):
                y_mid = y_mid + data[d, h : n_loc - h] * x_loc[h + off : n_loc - h + off]
            left, right = pending.wait()
            # Boundary strips read the halos (same per-row diagonal order as
            # the unoverlapped path → bit-identical rows).
            x_head = torch.cat([left, x_loc[: 2 * h]])  # covers rows [0, h)
            x_tail = torch.cat([x_loc[n_loc - 2 * h :], right])
            y_head = torch.zeros(h, dtype=x_loc.dtype, device=x_loc.device)
            y_tail = torch.zeros(h, dtype=x_loc.dtype, device=x_loc.device)
            for d, off in enumerate(offsets):
                y_head = y_head + data[d, :h] * x_head[h + off : 2 * h + off]
                # Row n_loc−h+i reads x_ext[h + n_loc−h+i + off] =
                # x_tail[h + i + off] with x_tail starting at n_loc−2h.
                y_tail = y_tail + data[d, n_loc - h :] * x_tail[h + off : 2 * h + off]
            return torch.cat([y_head, y_mid, y_tail])

        return matvec


def partition_dia(dia, num_parts: int, *, align: int = 1, device="cuda") -> PartitionedDIA:
    """Split a DIA operator into P contiguous row blocks (host-side).

    ``align``: round the local block size up to a multiple (shard
    boundaries land on multiples of ``align``).  The diagonals go to
    ``device``, the card unless the caller asks for the CPU.
    """
    n = dia.shape[0]
    D = dia.num_diags
    Pn = num_parts
    n_loc = -(-n // Pn)
    n_loc = -(-n_loc // align) * align
    h = max(abs(o) for o in dia.offsets)
    if h > n_loc:
        raise ValueError(
            f"band halo {h} exceeds local rows {n_loc}; use fewer parts"
        )
    data = host(dia.data)
    if n_loc * Pn != n:
        data = np.pad(data, ((0, 0), (0, n_loc * Pn - n)))
    data = data.reshape(D, Pn, n_loc).transpose(1, 0, 2)  # (P, D, n_loc)
    return PartitionedDIA(
        num_parts=Pn,
        n_global=n,
        n_loc=n_loc,
        h=h,
        offsets=tuple(int(o) for o in dia.offsets),
        data=torch.as_tensor(np.ascontiguousarray(data), device=resolve_device(device)),
    )


def _partition_vec(pdia: PartitionedDIA, x: torch.Tensor) -> torch.Tensor:
    pad = pdia.num_parts * pdia.n_loc - pdia.n_global
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(pdia.num_parts, pdia.n_loc)


def sharded_dia_solve(
    pdia: PartitionedDIA,
    b,
    x0=None,
    *,
    mesh=None,
    method: str = "cg",
    options=None,
    precond_diag=None,
    amg=None,
    overlap: bool = True,
    **solver_kw,
):
    """Krylov solve with the banded operator split over the ranks of
    ``mesh`` (default: :func:`make_device_mesh` on the default group):
    neighbour halo shifts inside the operator (overlapped with the interior
    rows by default), all-reduces inside the dots.  ``b``/``x0`` and the
    result are global.

    ``amg`` (the JAX package's ``DistributedBlockDiaAmg``) waits for the
    next slice of the port and raises ``NotImplementedError``.
    """
    from stormx_torch.parallel.sharded import _global, _mesh_for, _run_local_solve
    from stormx_torch.solvers import make_operator

    if amg is not None:
        raise NotImplementedError(
            "DistributedBlockDiaAmg is not ported yet (ROADMAP.md §1 item 6)"
        )
    mesh = _mesh_for(pdia.num_parts, mesh)
    r, dev = mesh.rank, mesh.device
    b = _global(b, pdia.data, dev)
    x0 = torch.zeros_like(b) if x0 is None else _global(x0, b, dev)

    def to_local(v):
        return _partition_vec(pdia, _global(v, b, dev))[r].contiguous()

    pre = None
    if precond_diag is not None:
        from stormx_torch.precond import JacobiPreconditioner

        pre = JacobiPreconditioner(diag=to_local(precond_diag))
    op = make_operator(pdia.local_matvec(mesh, overlap=overlap))
    res = _run_local_solve(method, op, to_local(b), to_local(x0), mesh=mesh, options=options,
                           pre=pre, solver_kw=dict(solver_kw), n_global=pdia.n_global,
                           to_local=to_local)
    return res._replace(x=mesh.all_gather(res.x).reshape(-1)[: pdia.n_global])
