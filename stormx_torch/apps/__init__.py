from stormx_torch.apps import cahn_hilliard, euler, laplace2d, navier_stokes

__all__ = ["cahn_hilliard", "euler", "laplace2d", "navier_stokes"]
