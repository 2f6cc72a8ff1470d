from stormx_torch.precond.block_amg import BlockDiaAmg
from stormx_torch.precond.jacobi import JacobiPreconditioner

__all__ = ["BlockDiaAmg", "JacobiPreconditioner"]
