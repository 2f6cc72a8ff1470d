from stormx_torch.parallel.partition import bandwidth_order, rcm_order

__all__ = ["bandwidth_order", "rcm_order"]
