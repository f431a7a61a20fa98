#!/usr/bin/env python
"""Structured cuboid mesh generator (gmsh 2.2 ASCII output).

Equivalent of the legacy Reference Project's gmsh-python generators
(ref: Reference Project/config/mesh/mesh_generator/cuboid_uniform_mesh.py):
an n x n x n unit cuboid split into 6 tets per cell with physical surface
groups Left/Right/Back/Front/Bottom/Top (tags 1-6), written directly in the
gmsh 2.2 format pbte.mesh.gmsh_io parses — no gmsh dependency.

Usage:
    python scripts/generate_mesh.py N [out.msh]
    python scripts/generate_mesh.py 5 config/mesh/cuboid_5x5x5.msh
"""

from __future__ import annotations

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from pbte.mesh import builtins


PHYSICAL_NAMES = {
    1: "Bottom", 2: "Front", 3: "Right", 4: "Back", 5: "Left", 6: "Top",
}


def write_gmsh22(mesh, path: str, physical_names=PHYSICAL_NAMES) -> None:
    """Write a MeshData (tet) as gmsh 2.2 ASCII with boundary triangles."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write("$PhysicalNames\n%d\n" % len(physical_names))
        for tag, name in sorted(physical_names.items()):
            f.write(f'2 {tag} "{name}"\n')
        f.write("$EndPhysicalNames\n")
        f.write("$Nodes\n%d\n" % mesh.num_vertices)
        for i, v in enumerate(mesh.vertices, start=1):
            coords = list(v) + [0.0] * (3 - len(v))
            f.write(f"{i} {coords[0]:.16g} {coords[1]:.16g} {coords[2]:.16g}\n")
        f.write("$EndNodes\n")
        n_entities = len(mesh.bdry_verts) + mesh.num_elements
        f.write("$Elements\n%d\n" % n_entities)
        eid = 1
        for attr, verts in zip(mesh.bdry_attr, mesh.bdry_verts):
            vs = " ".join(str(int(v) + 1) for v in verts)
            f.write(f"{eid} 2 2 {attr} {attr} {vs}\n")
            eid += 1
        for attr, verts in zip(mesh.elem_attr, mesh.elem_verts):
            vs = " ".join(str(int(v) + 1) for v in verts)
            f.write(f"{eid} 4 2 {attr} {attr} {vs}\n")
            eid += 1
        f.write("$EndElements\n")


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    n = int(argv[1])
    out = argv[2] if len(argv) > 2 else f"cuboid_{n}x{n}x{n}.msh"
    mesh = builtins.make_cartesian_3d(n, n, n, "tet")
    write_gmsh22(mesh, out)
    print(f"wrote {out}: {mesh.num_elements} tets, {mesh.num_vertices} nodes, "
          f"{len(mesh.bdry_verts)} boundary tris")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
