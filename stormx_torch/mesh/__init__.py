from stormx_torch.mesh import shapes
from stormx_torch.mesh.structured import structured_tri_rect
from stormx_torch.mesh.tetgen import read_tetgen
from stormx_torch.mesh.unstructured import (
    DeviceMesh,
    UnstructuredMesh,
    build_hybrid_mesh,
    build_mesh,
)

__all__ = [
    "shapes",
    "read_tetgen",
    "DeviceMesh",
    "UnstructuredMesh",
    "build_mesh",
    "build_hybrid_mesh",
    "structured_tri_rect",
]
