"""Distributed (shard-safe) aggregation AMG for ``sharded_solve``
(counterpart of ``stormx/parallel/amg.py``).

One symmetric V-cycle per apply:

* **fine smooth** — weighted Jacobi through the solve's own halo-exchanging
  local operator;
* **restrict** — shard-local ``segment_sum`` by aggregate id into the coarse
  space, then ONE ``all_reduce_sum`` (aggregates may straddle partition
  boundaries); the coarse residual is then the same on every rank;
* **coarse correct** — the serial
  :class:`~stormx_torch.precond.AmgPreconditioner` V-cycle on the Galerkin
  coarse operator, computed identically on every rank.  In float32 on the
  card its first level's products are kernel K1, as the serial AMG's are;
* **prolong** — one shard-local gather ``e_c[agg]``; **post-smooth** as the
  pre-smooth, so the cycle is symmetric and CG-safe on SPD operators.

Partition invariance: everything but the restriction's all-reduce (and the
outer solve's dots) is bit-exact per rank.  That all-reduce regroups sums
inside the preconditioner, so histories agree across P to ~1e-7 relative,
as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.precond.multigrid import AmgPreconditioner, _coarsen, aggregate
from stormx_torch.sparse.formats import CSR, dtype_of, host

__all__ = ["DistributedAmg"]


class DistributedAmg:
    """Host-built factors for a distributed AMG V-cycle.

    ``csr``: the GLOBAL operator (original row order); ``pop``: the
    :class:`~stormx_torch.parallel.PartitionedOperator` the solve will run
    with (it gives the slot layout).  ``dtype`` is the solve's vector dtype
    (default the CSR's) and ``device`` the ranks' device, the card unless
    the caller asks for the CPU.  Pass to ``sharded_solve`` as ``amg=``.
    """

    def __init__(self, csr, pop, *, num_sweeps: int = 1,
                 omega: float = 2.0 / 3.0, coarse_size: int = 64,
                 max_levels: int = 10, dtype: torch.dtype | None = None, device="cuda"):
        dev = resolve_device(device)
        dtype = dtype or dtype_of(csr.data)
        self.num_sweeps = num_sweeps
        self.omega = omega

        row_ptr = host(csr.row_ptr).astype(np.int64)
        cols = host(csr.indices).astype(np.int64)
        vals = host(csr.data).astype(np.float64)
        n = csr.shape[0]

        agg = aggregate(row_ptr, cols, vals, n)
        nc = int(agg.max()) + 1
        self.nc = nc

        rows = np.repeat(np.arange(n), np.diff(row_ptr))
        diag = np.zeros(n)
        np.add.at(diag, rows[cols == rows], vals[cols == rows])
        inv_diag = np.where(diag != 0.0, 1.0 / np.where(diag == 0, 1, diag), 0.0)

        # Slot layout (padding slots: aggregate id nc = dump, inv_diag 0).
        P, n_pad = pop.num_parts, pop.n_pad
        slot_agg = np.full(P * n_pad, nc, dtype=np.int64)
        slot_agg[pop.fill_slots] = agg[pop.perm]
        slot_idiag = np.zeros(P * n_pad)
        slot_idiag[pop.fill_slots] = inv_diag[pop.perm]
        self.agg_slots = torch.as_tensor(slot_agg.reshape(P, n_pad), device=dev)
        self.idiag_slots = torch.as_tensor(slot_idiag.reshape(P, n_pad), device=dev).to(dtype)

        # Galerkin coarse operator (global, replicated) → serial V-cycle.
        c_ptr, c_cols, c_vals = _coarsen(row_ptr, cols, vals, n, agg, nc)
        coarse_csr = CSR(data=c_vals, indices=c_cols.astype(np.int32),
                         row_ptr=c_ptr.astype(np.int32), shape=(nc, nc))
        self.coarse = AmgPreconditioner(
            coarse_csr, num_sweeps=num_sweeps, coarse_size=coarse_size,
            max_levels=max_levels, omega=omega, dtype=dtype, device=dev,
            fine_matvec=_kernel_matvec(coarse_csr, dtype, dev),
        )

    def extras(self) -> dict:
        """The per-rank arrays, stacked over the ranks (the JAX package's
        operands for ``sharded_solve``)."""
        return {"amg_agg": self.agg_slots, "amg_idiag": self.idiag_slots}

    def make_apply(self, mv, agg_loc, idiag_loc, axis_name):
        """The local V-cycle apply of one rank.

        ``mv``: the halo-exchanging LOCAL product (n_pad,) → (n_pad,);
        ``agg_loc``/``idiag_loc``: this rank's rows of ``agg_slots`` and
        ``idiag_slots``; ``axis_name``: the rank's mesh handle.
        """
        from stormx_torch.ops.segment import segment_sum

        nc, omega, sweeps = self.nc, self.omega, self.num_sweeps
        coarse = self.coarse

        def apply(r):
            # Pre-smooth from zero: the first sweep collapses to ω·D⁻¹·r.
            x = omega * idiag_loc * r
            for _ in range(sweeps - 1):
                x = x + omega * idiag_loc * (r - mv(x))
            # Restrict the residual: local partial sums + one all-reduce.
            rr = r - mv(x)
            rc = segment_sum(rr, agg_loc, nc + 1)  # slot nc = padding dump
            rc = axis_name.all_reduce_sum(rc)[:nc]
            ec = coarse(rc)  # the same serial V-cycle on every rank
            x = x + torch.cat([ec, ec.new_zeros(1)])[agg_loc]
            # Post-smooth (same smoother ⇒ symmetric cycle).
            for _ in range(sweeps):
                x = x + omega * idiag_loc * (r - mv(x))
            return x

        return apply


def _kernel_matvec(csr, dtype, device):
    """The coarse operator's product through kernel K1 where the serial AMG
    would take it: float32 on the card, when ``auto_operator`` gives a
    SlicedELL.  None elsewhere (the level's plain ELL product)."""
    if not (device.type == "cuda" and dtype == torch.float32):
        return None
    from stormx_torch.sparse.windowed import SlicedELL, auto_operator

    f32 = CSR(data=host(csr.data).astype(np.float32), indices=csr.indices,
              row_ptr=csr.row_ptr, shape=csr.shape)
    op, perm = auto_operator(f32, device=device)
    if not (isinstance(op, SlicedELL) and op.mode == "cuda"):
        return None
    perm = torch.as_tensor(perm, device=device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(perm), device=device)
    return lambda x: op.matvec(x[perm].contiguous())[inv]
