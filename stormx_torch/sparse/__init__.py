from stormx_torch.sparse.formats import (
    BSR,
    COO,
    CSR,
    DIA,
    ELL,
    bsr_from_csr,
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
    "BSR",
    "COO",
    "CSR",
    "DIA",
    "ELL",
    "SlicedELL",
    "bsr_from_csr",
    "csr_from_dense",
    "dia_from_csr",
    "ell_add",
    "ell_from_csr",
    "ell_spgemm",
    "sell_from_csr",
    "sell_from_ell",
    "auto_operator",
]
