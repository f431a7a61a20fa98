"""Mesh layer: ingestion, builtins, refinement, connectivity.

JAX replacement for pbte::SpatialMesh (ref: include/SpatialMesh.hpp)
and the legacy SpatialMesh<dim> object graph. Meshes are flat numpy arrays
(`MeshData`) with derived face-connectivity tensors (`MeshTopology`).
"""

from pbte.mesh.core import (  # noqa: F401
    GEOM_HEX,
    GEOM_MIXED,
    GEOM_QUAD,
    GEOM_TET,
    GEOM_TRIANGLE,
    MeshData,
    MeshTopology,
    connect,
    make_periodic,
    finalize,
)
from pbte.mesh.builtins import (  # noqa: F401
    load_builtin,
    make_cartesian_2d,
    make_cartesian_3d,
    make_mixed_2d,
)
from pbte.mesh.mfem_io import load_mfem_mesh, parse_mfem_mesh, write_mfem_mesh  # noqa: F401
from pbte.mesh.refine import uniform_refine  # noqa: F401


def load_mesh(spec: str) -> MeshData:
    """Load a mesh file or a built-in name (ref: src/SpatialMesh.cpp:66-81)."""
    import os

    if os.path.exists(spec):
        if spec.endswith(".msh"):
            from pbte.mesh.gmsh_io import load_gmsh_mesh

            return load_gmsh_mesh(spec)
        return load_mfem_mesh(spec)
    if os.sep in spec or spec.endswith((".mesh", ".msh")):
        raise FileNotFoundError(f"mesh file not found: {spec}")
    return load_builtin(spec)
