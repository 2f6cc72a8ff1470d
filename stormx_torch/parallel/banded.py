"""Distributed banded (DIA) operators with neighbour halo shifts
(counterpart of ``stormx/parallel/banded.py``).

For a banded operator a row-block partition needs only the band edges of its
two NEIGHBOUR blocks — h = max|offset| values each way — so the halo is two
neighbour shifts (``RankMesh.exchange``), not an all-gather:

    per CG iteration: 1 exchange (both shifts) + 2 all-reduces (dots),
    everything else rank-local elementwise streams.

The outer ranks receive zeros from the missing neighbour, which is exactly
right because out-of-band DIA entries are zero.  The JAX package's slab
product is XLA slices; here each row range of a slab is one rectangular DIA
operator, so on the card the slabs run kernel K2a, as the serial
``DIA.matvec`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.sparse.formats import DIA, host

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

        Each row range is one rectangular DIA operator over the part of the
        halo-extended ``x_ext = [left h | x_loc | right h]`` it reads, with
        the offsets moved by ``h``, so on the card every range is one launch
        of kernel K2a (the serial ``DIA.matvec``'s), and on the CPU its
        plain version.  ``overlap=True`` (default, needs ``n_loc >= 2h``):
        the halo shifts are started first, the interior rows [h, n_loc−h) —
        whose band stays inside the local block — are computed from
        ``x_loc`` alone while they are in flight, and only the h-row head
        and tail strips read the halos.  Every range adds its row's
        diagonals in the same order, so the result is bit-identical to the
        unoverlapped path and to the serial product.
        """
        from stormx_torch.ops.dia import dia_spmv

        mesh = axis_name
        h, n_loc = self.h, self.n_loc
        data = self.data[mesh.rank].to(mesh.device)
        shifted = tuple(o + h for o in self.offsets)

        def rows(lo, hi, n_cols):
            """Rows [lo, hi) as a DIA operator over n_cols entries of x_ext
            starting at x_ext[lo]."""
            return DIA(data=data[:, lo:hi].contiguous(), offsets=shifted, shape=(hi - lo, n_cols))

        if h == 0:
            whole = rows(0, n_loc, n_loc)
            return lambda x_loc: dia_spmv(whole, x_loc)

        def shifts(x_loc, async_op=False):
            # My tail → next rank's left halo; my head → previous rank's
            # right halo.  Missing neighbours zero-fill.
            return mesh.exchange(x_loc[-h:], x_loc[:h], async_op=async_op)

        if not overlap or n_loc < 2 * h:
            whole = rows(0, n_loc, n_loc + 2 * h)

            def matvec(x_loc):
                left, right = shifts(x_loc)
                return dia_spmv(whole, torch.cat([left, x_loc, right]))

            return matvec

        # Interior rows i ∈ [h, n_loc−h) read x_ext[i + h + off] =
        # x_loc[i + off]: the operator over x_loc starting at row h.
        mid = rows(h, n_loc - h, n_loc)
        head = rows(0, h, 3 * h)  # over [left | x_loc[:2h]]
        tail = rows(n_loc - h, n_loc, 3 * h)  # over [x_loc[n_loc−2h:] | right]

        def matvec(x_loc):
            pending = shifts(x_loc, async_op=True)  # started before the interior
            y_mid = dia_spmv(mid, x_loc)
            left, right = pending.wait()
            y_head = dia_spmv(head, torch.cat([left, x_loc[: 2 * h]]))
            y_tail = dia_spmv(tail, torch.cat([x_loc[n_loc - 2 * h :], right]))
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

    ``amg``: a :class:`~stormx_torch.parallel.DistributedBlockDiaAmg`
    built for THIS ``pdia``, a distributed V-cycle whose output is
    bit-identical for every P (excludes ``precond_diag``).
    """
    from stormx_torch.parallel.sharded import _global, _mesh_for, _run_local_solve
    from stormx_torch.solvers import make_operator

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
    if amg is not None:
        if precond_diag is not None:
            raise ValueError("amg=... excludes precond_diag")
        if amg.num_parts != pdia.num_parts or amg.pdias[0].n_loc != pdia.n_loc:
            raise ValueError(
                "amg was built for a different partition "
                f"(P={amg.num_parts}, n_loc={amg.pdias[0].n_loc}) than "
                f"this solve (P={pdia.num_parts}, n_loc={pdia.n_loc})"
            )
        from stormx_torch.solvers.preconditioner import FunctionPreconditioner

        pre = FunctionPreconditioner(amg.make_apply(mesh))
    op = make_operator(pdia.local_matvec(mesh, overlap=overlap))
    res = _run_local_solve(method, op, to_local(b), to_local(x0), mesh=mesh, options=options,
                           pre=pre, solver_kw=dict(solver_kw), n_global=pdia.n_global,
                           to_local=to_local)
    return res._replace(x=mesh.all_gather(res.x).reshape(-1)[: pdia.n_global])
