"""Concrete preconditioners (counterpart of ``stormx/precond``), grouped as
the JAX package groups them:

* **diagonal family** (Jacobi, block-Jacobi);
* **polynomial** (Chebyshev) — operator products only (K1 on the card);
* **incomplete factorizations** (SGS, ILU(0), IC(0)) — host factorization,
  device triangular solves (exact level-scheduled or fixed Jacobi sweeps);
* **incomplete QR** (CIMGS: IC(0) of AᵀA) — right preconditioner for
  LSQR/LSMR on rectangular systems;
* **approximate inverses** (SPAI(0), AINV) — host build, SpMV-only apply;
* **multigrid** (aggregation AMG V-cycle; ``BlockDiaAmg`` on DIA operators);
* **Krylov** — nonlinear inner solve, for flexible outer methods (FGMRES).
"""

from stormx_torch.precond.approx_inverse import AinvPreconditioner, SpaiPreconditioner
from stormx_torch.precond.block_amg import BlockDiaAmg
from stormx_torch.precond.chebyshev import ChebyshevPreconditioner
from stormx_torch.precond.factorized import (
    IcPreconditioner,
    IluPreconditioner,
    SgsPreconditioner,
)
from stormx_torch.precond.iqr import IqrPreconditioner
from stormx_torch.precond.jacobi import BlockJacobiPreconditioner, JacobiPreconditioner
from stormx_torch.precond.krylov import KrylovPreconditioner
from stormx_torch.precond.multigrid import AmgPreconditioner
from stormx_torch.precond.triangular import TriangularFactor, build_triangular, tri_solve

__all__ = [
    "JacobiPreconditioner",
    "BlockJacobiPreconditioner",
    "ChebyshevPreconditioner",
    "AmgPreconditioner",
    "BlockDiaAmg",
    "SgsPreconditioner",
    "IluPreconditioner",
    "IcPreconditioner",
    "SpaiPreconditioner",
    "AinvPreconditioner",
    "IqrPreconditioner",
    "KrylovPreconditioner",
    "TriangularFactor",
    "build_triangular",
    "tri_solve",
]
