from stormx_torch.fvm.divgrad import (
    assemble_divgrad,
    assemble_divgrad_dia,
    assemble_laplacian,
    div_grad,
    face_flux_coefficients,
)

__all__ = [
    "assemble_divgrad",
    "assemble_divgrad_dia",
    "assemble_laplacian",
    "div_grad",
    "face_flux_coefficients",
]
