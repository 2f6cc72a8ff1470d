from stormx_torch.precond.jacobi import JacobiPreconditioner

__all__ = ["JacobiPreconditioner"]
