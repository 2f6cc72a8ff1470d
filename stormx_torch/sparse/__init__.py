from stormx_torch.sparse.formats import (
    COO,
    CSR,
    DIA,
    ELL,
    csr_from_dense,
    dia_from_csr,
    ell_add,
    ell_from_csr,
    ell_spgemm,
)
from stormx_torch.sparse.windowed import (
    SlicedELL,
    auto_operator,
    sell_from_csr,
    sell_from_ell,
)

__all__ = [
    "COO",
    "CSR",
    "DIA",
    "ELL",
    "SlicedELL",
    "csr_from_dense",
    "dia_from_csr",
    "ell_add",
    "ell_from_csr",
    "ell_spgemm",
    "sell_from_csr",
    "sell_from_ell",
    "auto_operator",
]
