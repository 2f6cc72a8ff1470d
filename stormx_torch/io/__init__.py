from stormx_torch.io.checkpoint import (
    Checkpointer,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from stormx_torch.io.viz import plot_cell_field, plot_convergence, visualize_mesh
from stormx_torch.io.vtk import write_vtk

__all__ = [
    "write_vtk",
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "Checkpointer",
    "visualize_mesh",
    "plot_cell_field",
    "plot_convergence",
]
