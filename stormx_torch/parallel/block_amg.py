"""Distributed gather-free block AMG for banded (DIA) operators, bit-exact
across partition counts (counterpart of ``stormx/parallel/block_amg.py``).

:class:`~stormx_torch.precond.block_amg.BlockDiaAmg` aggregates ``g``
consecutive rows, so when rank boundaries fall on multiples of ``g``
(``partition_dia(..., align=g)``) no aggregate straddles two ranks and
every V-cycle ingredient is rank-local or an exact collective:

* smoothing — weighted Jacobi through the halo-exchanging
  :meth:`PartitionedDIA.local_matvec` (kernel K2a on every row range of a
  slab on the card; each row adds its diagonals in the serial order);
* restriction — the sum of each aggregate's ``g`` entries on the rank, in
  index order, with no all-reduce;
* prolongation — ``repeat_interleave`` on the rank;
* coarse levels — distributed while the band halo fits one neighbour block
  and ``g`` still divides the local block, then ONE ``all_gather`` (an
  exact concatenation) and the rest of the serial hierarchy, the same on
  every rank (its level products are ``DIA.matvec``, K2a on the card; its
  dense coarse solve one product).

The only collectives are halo shifts (exact neighbour copies) and one
all-gather (an exact concatenation), so the preconditioner's output is
bit-identical for every P, unlike :class:`~stormx_torch.parallel.
DistributedAmg`, whose restriction all-reduce regroups sums.  Outer CG
histories across P then agree to plain CG's dot-regrouping contract.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.precond.block_amg import BlockDiaAmg, prolong_repeat
from stormx_torch.sparse.formats import DIA, host

__all__ = ["DistributedBlockDiaAmg"]


def _restrict_in_order(r: torch.Tensor, g: int) -> torch.Tensor:
    """(n_loc,) → (n_loc/g,): each aggregate's g entries added in index
    order, so a row's sum does not depend on how many rows a rank holds."""
    v = r.reshape(-1, g)
    out = v[:, 0]
    for j in range(1, g):
        out = out + v[:, j]
    return out


class DistributedBlockDiaAmg:
    """Host-built factors for the distributed block-DIA V-cycle.

    ``dia``: the GLOBAL operator; ``pdia``: the
    :class:`~stormx_torch.parallel.PartitionedDIA` the solve will run with,
    built with ``partition_dia(dia, P, align=group)`` so rank boundaries
    line up with the aggregates (checked here).  The levels are in the
    operator's dtype on ``device``, the ranks' device: the card unless the
    caller asks for the CPU.  Pass to
    :func:`~stormx_torch.parallel.sharded_dia_solve` as ``amg=<this>``.
    """

    def __init__(self, dia, pdia, *, group: int = 4, num_sweeps: int = 1,
                 omega: float = 2.0 / 3.0, coarse_size: int = 256,
                 max_levels: int = 16, device="cuda"):
        from stormx_torch.parallel.banded import PartitionedDIA

        dev = resolve_device(device)
        g = int(group)
        if pdia.n_loc % g:
            raise ValueError(
                f"shard size {pdia.n_loc} not a multiple of group {g}; "
                f"build the partition with partition_dia(dia, P, align={g})"
            )
        # The serial hierarchy defines every level operator and the dense
        # coarse factor; the distributed apply reuses its coarse tail as it
        # is, so P = 1 and P > 1 applies agree bit for bit.
        data = torch.as_tensor(host(dia.data), device=dev)
        self.serial = BlockDiaAmg(
            DIA(data=data, offsets=tuple(int(o) for o in dia.offsets), shape=tuple(dia.shape)),
            group=g, num_sweeps=num_sweeps, omega=omega, coarse_size=coarse_size,
            max_levels=max_levels,
        )
        self.group = g
        self.num_sweeps = num_sweeps
        self.omega = omega
        self.num_parts = Pn = pdia.num_parts

        # Distribute levels greedily: level k runs on the ranks with
        # n_loc_k = n_loc_0 / g^k while (a) the band halo fits one
        # neighbour block and (b) g still divides the local block (so the
        # NEXT restriction stays on the rank).  The first level that fails
        # is the replicated entry point.
        self.pdias: list[PartitionedDIA] = []
        n_loc = pdia.n_loc
        for lvl in self.serial._levels:
            op = lvl["op"]
            h = max(abs(int(o)) for o in op.offsets)
            if n_loc % g or h > n_loc:
                break
            lvl_data = host(op.data)
            n_k = lvl["n"]
            if Pn * n_loc != n_k:
                lvl_data = np.pad(lvl_data, ((0, 0), (0, Pn * n_loc - n_k)))
            lvl_data = lvl_data.reshape(op.num_diags, Pn, n_loc).transpose(1, 0, 2)
            self.pdias.append(PartitionedDIA(
                num_parts=Pn, n_global=n_k, n_loc=n_loc, h=h,
                offsets=tuple(int(o) for o in op.offsets),
                data=torch.as_tensor(np.ascontiguousarray(lvl_data), device=dev),
            ))
            n_loc //= g
        if not self.pdias:
            raise ValueError(
                "no level is distributable (halo exceeds the local block "
                "even at the finest level); use fewer parts"
            )
        self.dist_depth = len(self.pdias)
        # n_loc of the REPLICATED entry residual (one restriction below
        # the last distributed level).
        self._n_loc_entry = self.pdias[-1].n_loc // g

        # Per-rank inverse diagonals, padded like the data.
        self._idiag = []
        for k, pd in enumerate(self.pdias):
            idiag = host(self.serial._levels[k]["inv_diag"])
            idiag = np.pad(idiag, (0, Pn * pd.n_loc - idiag.shape[0]))
            self._idiag.append(torch.as_tensor(idiag.reshape(Pn, pd.n_loc), device=dev))

    def extras(self) -> dict:
        """The per-rank arrays of every distributed level, stacked over the
        ranks (the JAX package's operands for ``sharded_dia_solve``)."""
        out = {}
        for k, pd in enumerate(self.pdias):
            out[f"bamg_data{k}"] = pd.data
            out[f"bamg_idiag{k}"] = self._idiag[k]
        return out

    def make_apply(self, axis_name):
        """The local V-cycle of the rank of ``axis_name`` (its mesh handle),
        with that rank's level slabs and inverse diagonals bound on its
        device.  (The JAX package passes the rank's slices of
        :meth:`extras` in; here each level's ``local_matvec`` binds them, as
        ``PartitionedDIA`` does.)"""
        mesh = axis_name
        g, omega, sweeps = self.group, self.omega, self.num_sweeps
        serial, K, Pn = self.serial, self.dist_depth, self.num_parts
        r, dev = mesh.rank, mesh.device
        matvecs = [pd.local_matvec(mesh) for pd in self.pdias]
        idiags = [d[r].to(dev) for d in self._idiag]
        n_entry = (serial._levels[K]["n"] if K < len(serial._levels)
                   else serial._coarse_inv.shape[0])
        n_loc_entry = self._n_loc_entry

        def smooth(x, b, mv, idiag, *, from_zero=False):
            nloops = sweeps
            if from_zero:
                x = omega * idiag * b  # skip the product of zeros
                nloops -= 1
            for _ in range(nloops):
                x = x + omega * idiag * (b - mv(x))
            return x

        def vcycle(k, b_loc):
            if k == K:
                # Exact concatenation; every rank then runs the same serial
                # coarse tail (replicated, small).
                full = mesh.all_gather(b_loc).reshape(-1)
                e = serial._vcycle(K, full[:n_entry])
                e = torch.nn.functional.pad(e, (0, Pn * n_loc_entry - n_entry))
                return e[r * n_loc_entry : (r + 1) * n_loc_entry]
            mv, idiag = matvecs[k], idiags[k]
            x = smooth(None, b_loc, mv, idiag, from_zero=True)
            res = b_loc - mv(x)
            n_loc = res.shape[0]
            # Rank-local because no aggregate straddles two ranks (g | n_loc,
            # checked at build).
            e_c = vcycle(k + 1, _restrict_in_order(res, g))
            x = x + prolong_repeat(e_c, n_loc, g)
            return smooth(x, b_loc, mv, idiag)

        return lambda v: vcycle(0, v)
