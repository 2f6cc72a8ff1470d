"""Sharded Krylov solves on ``torch.distributed`` (counterpart of
``stormx/parallel/sharded.py``).

The two communication points of a Krylov iteration on a partitioned mesh
map to:

* dot products and norms → one ``all_reduce`` each, inside
  ``stormx_torch.ops.vector`` through the ``axis_name`` handle;
* the operator's halo exchange → one ``all_gather`` of shared-boundary
  cells inside the local product.

Every rank runs the same solver loop on its own slab and calls these
functions with the same global ``b`` and ``x0``; every stopping test reads
an all-reduced value, so all ranks take the same number of iterations and
return the same history and the same global ``x`` (all-gathered at the
end).  The JAX package compiles one program per solve and caches it; an
eager port has no program to cache.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from stormx_torch.core.exceptions import StormError
from stormx_torch.parallel.comm import RankMesh, make_device_mesh
from stormx_torch.parallel.partition import (
    PartitionedOperator,
    partition_vector,
    unpartition_vector,
)
from stormx_torch.solvers import SOLVERS, SolverOptions, make_operator

__all__ = ["make_device_mesh", "sharded_solve", "sharded_matvec"]

_GMRES_FAMILY = frozenset({"gmres", "fgmres", "lgmres", "lfgmres"})


def _orthog_default(method, solver_kw):
    """CGS2 is the *distributed* GMRES-family default: each CGS2 pass is one
    stacked (k+1, n)·(n,) product, so 2 all-reduces per inner step at any
    basis length k, against MGS's k+1 sequential ones.  An explicit
    ``orthog=`` always wins; serial ``gmres()`` keeps the reference's MGS."""
    if method.lower() in _GMRES_FAMILY and "orthog" not in solver_kw:
        solver_kw = dict(solver_kw, orthog="cgs2")
    return solver_kw


def _mesh_for(num_parts: int, mesh: RankMesh | None) -> RankMesh:
    mesh = mesh or make_device_mesh(num_parts)
    if mesh.size != num_parts:
        raise StormError(
            f"the operator is split into {num_parts} parts but the mesh has {mesh.size} ranks"
        )
    return mesh


def _global(x, like: torch.Tensor, device) -> torch.Tensor:
    """A caller's global vector as a tensor of the operator's dtype (complex
    vectors keep their complex type) on ``device``."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    dtype = torch.promote_types(like.dtype, x.dtype) if x.is_complex() else like.dtype
    return x.to(device=device, dtype=dtype)


def _rank_precond(precond, mesh):
    """This rank's copy of a shard-safe preconditioner: ``build`` binds the
    rank's local operator to the instance, so ranks never share one, and
    ``with_axis_name`` re-wires inner reductions to the mesh.  The user's
    instance is never mutated."""
    if precond is None:
        return None
    pre = copy.copy(precond)
    if hasattr(pre, "with_axis_name"):
        pre = pre.with_axis_name(mesh)
    return pre


def _idrs_shadow(solver_kw, n_global: int, to_local):
    """IDR(s)'s shadow basis drawn in GLOBAL layout (``sharded.py:206-219``):
    rank-local draws would tile the same values on every rank and make the
    history depend on the partition count.  Padding slots stay zero."""
    from stormx_torch.solvers.idrs import _SHADOW_SEED

    s = solver_kw.get("s", 4)
    seed = solver_kw.pop("shadow_seed", _SHADOW_SEED)
    raws = np.random.default_rng(seed).standard_normal((s - 1, n_global))
    return torch.stack([to_local(row) for row in raws])


def _run_local_solve(method, op, b_loc, x0_loc, *, mesh, options, pre, solver_kw,
                    n_global: int, to_local):
    """The solver loop of one rank (shared by the CSR, DIA and sliced
    solves)."""
    solver_kw = _orthog_default(method, solver_kw)
    if method.lower() == "idrs" and "shadow" not in solver_kw:
        solver_kw = dict(solver_kw)
        solver_kw["shadow"] = _idrs_shadow(solver_kw, n_global, to_local)
    try:
        solver_fn = SOLVERS[method.lower()]
    except KeyError:
        raise ValueError(f"unknown solver {method!r}; choose from {sorted(SOLVERS)}") from None
    return solver_fn(op, b_loc, x0_loc, precond=pre, options=options or SolverOptions(),
                     axis_name=mesh, **solver_kw)


def sharded_matvec(pop: PartitionedOperator, mesh: RankMesh | None = None, *,
                   overlap: bool = True):
    """The global product in partitioned layout: ``xp (P, n_pad) → (P,
    n_pad)``.  Each rank applies its slab (row ``mesh.rank`` of ``xp``, or
    its own ``(n_pad,)`` slab) and the result is all-gathered, so every rank
    returns the whole layout, as the JAX package's sharded array holds it."""
    mesh = _mesh_for(pop.num_parts, mesh)
    local = pop.local_matvec(mesh, overlap=overlap)

    def fn(xp):
        xp = torch.as_tensor(xp, device=mesh.device)
        x_loc = xp[mesh.rank] if xp.dim() == 2 else xp
        return mesh.all_gather(local(x_loc.contiguous()))

    return fn


def sharded_solve(
    pop: PartitionedOperator,
    b,
    x0=None,
    *,
    mesh: RankMesh | None = None,
    method: str = "cg",
    options: SolverOptions | None = None,
    precond_diag=None,
    precond=None,
    ras: str | None = None,
    amg=None,
    overlap: bool = True,
    **solver_kw,
):
    """Solve A·x = b with the operator partitioned over the ranks of
    ``mesh`` (default: :func:`make_device_mesh` on the default group).

    Every rank passes the same *global* (n,) ``b``/``x0`` and gets the same
    global result.  Per iteration: the dots are all-reduces, the halo is an
    all-gather.

    Preconditioning options (as in the JAX package):

    * ``precond_diag`` — a *global* (n,) diagonal, partitioned and applied
      as shard-local Jacobi scaling.
    * ``precond`` — a shard-safe preconditioner instance: built from
      replicated state and touching the vector only elementwise or through
      the operator (``ChebyshevPreconditioner`` with an explicit
      ``lambda_max``; ``KrylovPreconditioner``, whose inner reductions are
      re-wired through ``with_axis_name``).  Each rank works on its own copy.
      Host-factorized global preconditioners are not shard-safe: use ``ras``.
    * ``amg`` — a :class:`~stormx_torch.parallel.DistributedAmg` built for
      THIS ``pop``.
    * ``ras`` — ``"ilu0"`` or ``"sgs"``: restricted additive Schwarz on each
      partition's owned block (:mod:`stormx_torch.parallel.ras`).  Its
      history depends on the partition count.
    """
    mesh = _mesh_for(pop.num_parts, mesh)
    r, dev = mesh.rank, mesh.device
    b = _global(b, pop.data, dev)
    x0 = torch.zeros_like(b) if x0 is None else _global(x0, b, dev)

    def to_local(v):
        return partition_vector(pop, _global(v, b, dev))[r].contiguous()

    b_loc, x0_loc = to_local(b), to_local(x0)
    op = make_operator(pop.local_matvec(mesh, overlap=overlap))
    pre = _rank_precond(precond, mesh)
    if precond_diag is not None:
        from stormx_torch.precond import JacobiPreconditioner

        pre = JacobiPreconditioner(diag=to_local(precond_diag))
    if ras is not None:
        if precond_diag is not None or precond is not None or amg is not None:
            raise ValueError("ras=... excludes precond/precond_diag/amg")
        from stormx_torch.parallel.ras import _rank_preconditioner

        pre = _rank_preconditioner(pop, ras, r, dtype=b.dtype, device=dev)
    if amg is not None:
        if precond_diag is not None or precond is not None:
            raise ValueError("amg=... excludes precond/precond_diag")
        from stormx_torch.solvers.preconditioner import FunctionPreconditioner

        pre = FunctionPreconditioner(amg.make_apply(
            op.mul, amg.agg_slots[r].to(dev), amg.idiag_slots[r].to(dev, b.dtype), mesh))

    res = _run_local_solve(method, op, b_loc, x0_loc, mesh=mesh, options=options, pre=pre,
                          solver_kw=dict(solver_kw), n_global=pop.n_global, to_local=to_local)
    return res._replace(x=unpartition_vector(pop, mesh.all_gather(res.x)))
