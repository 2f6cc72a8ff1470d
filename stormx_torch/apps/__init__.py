from stormx_torch.apps import cahn_hilliard

__all__ = ["cahn_hilliard"]
