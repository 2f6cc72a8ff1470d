"""stormx_torch — the PyTorch / CUDA port of stormx for NVIDIA Hopper.

A second package beside the JAX one: the same sparse formats, FVM operators,
Krylov driver and apps, on tensors, with the TPU's Pallas kernels rewritten
as hand-written CUDA kernels for ``sm_90a`` (``stormx_torch/csrc``).  It
imports neither JAX nor ``stormx``; the parity tests hold it against both.
"""

from stormx_torch import core, ops, solvers, sparse
from stormx_torch.core import enable_x64, print_banner
from stormx_torch.solvers import (
    LinearOperator,
    SolveResult,
    SolverOptions,
    make_operator,
    make_symmetric_operator,
    solve,
    solve_non_uniform,
)

__version__ = "0.1.0"

__all__ = [
    "core",
    "ops",
    "solvers",
    "sparse",
    "enable_x64",
    "print_banner",
    "SolveResult",
    "SolverOptions",
    "LinearOperator",
    "make_operator",
    "make_symmetric_operator",
    "solve",
    "solve_non_uniform",
    "__version__",
]
