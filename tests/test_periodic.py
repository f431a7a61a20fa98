"""Periodic boundary conditions end-to-end.

The legacy reference pairs periodic faces in its mesh layer
(Reference Project/include/SpatialMesh/SpatialMesh.hpp:276-332) but its
solvers reject BC type 4 at solve time (PBTE_NonGraySMRT.cpp:125-127).
Here the pairing feeds a real lagged periodic coupling: paired faces are
masked from the upwind DAG (no cycles) and their inflow reads the previous
outer iterate, like a block-Jacobi partition interface.
"""

import numpy as np
import pytest

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.solver.source_iteration import SourceIterationSolver
from pbte.validation.oracle import solve_oracle

# x-periodic strip: bottom (attr 1) cold, top (attr 3) hot; left/right (2, 4)
# wrap. Builtin Cartesian 2D attrs: 1=bottom, 2=right, 3=top, 4=left.
BCS = {1: -0.5, 3: 0.5}


def _strip(nx=4, ny=3, geom=pmesh.GEOM_QUAD, order=1):
    m = pmesh.make_cartesian_2d(nx, ny, geom).scaled(1e-6)
    m = pmesh.make_periodic(m, [0])
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=order, face_mode="consistent")
    return m, topo, ops


def test_make_periodic_pairs_faces():
    m, topo, ops = _strip()
    per = topo.elem_face_periodic
    assert per.sum() == 2 * 3  # ny faces each side
    # pairing is symmetric and mutual
    for e, lf in np.argwhere(per):
        n = topo.elem_neighbor[e, lf]
        assert n >= 0
        back = np.argwhere(
            (topo.elem_neighbor[n] == e) & topo.elem_face_periodic[n]
        )
        assert len(back) == 1
        # attr neutralized, offset spans the domain
        assert topo.elem_face_attr[e, lf] == 0
        assert abs(abs(topo.periodic_offset[e, lf, 0]) - 1e-6) < 1e-18
        assert abs(topo.periodic_offset[e, lf, 1]) < 1e-18
    # ops view agrees; sweep neighbor masks the wrap
    assert np.array_equal(ops.periodic, per)
    assert (ops.sweep_neighbor[per] == -1).all()


def test_periodic_oracle_x_invariant():
    """With uniform BCs along x and x-wrap, converged T must not vary in x."""
    m, topo, ops = _strip(nx=3, ny=3)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=12))
    tables = mat.build_tables(mat.SILICON, num_spectral=3)
    u, Tc, Tv, res, it = solve_oracle(ops, quad, tables, BCS, tol=1e-9,
                                      max_iter=1500)
    assert res < 1e-9
    # element-mean temperature (Tv is the element INTEGRAL of T)
    Tmean = Tv / ops.basis_int.sum(axis=1)
    # group elements by their y-centroid; T equal within each row
    cy = np.round(topo.centroids[:, 1] / 1e-6 * 1e6).astype(int)
    for row in np.unique(cy):
        vals = Tmean[cy == row]
        assert np.abs(vals - vals[0]).max() < 1e-6
    # and the field is nontrivial in y (hot top, cold bottom)
    assert Tmean.max() - Tmean.min() > 0.1
    assert Tmean[np.argmax(topo.centroids[:, 1])] > 0


def test_periodic_solver_matches_oracle():
    m, topo, ops = _strip(nx=4, ny=3)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    uo, Tco, Tvo, _, _ = solve_oracle(ops, quad, tables, BCS, tol=0, max_iter=7)

    solver = SourceIterationSolver(ops, quad, tables, BCS)
    assert solver.has_periodic
    res = solver.solve(tol=0, max_iter=7, verbose=False)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(
        solver.u_by_direction(res.u), uo, rtol=1e-9, atol=1e-20
    )


def test_periodic_triangle_mesh_converges():
    m, topo, ops = _strip(nx=3, ny=2, geom=pmesh.GEOM_TRIANGLE)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    solver = SourceIterationSolver(ops, quad, tables, BCS)
    res = solver.solve(tol=1e-8, max_iter=2000, verbose=False)
    assert res.residual < 1e-8
    assert np.isfinite(np.asarray(res.Tc)).all()


def test_periodic_3d_hex():
    m = pmesh.make_cartesian_3d(2, 2, 3, pmesh.GEOM_HEX).scaled(1e-6)
    m = pmesh.make_periodic(m, [0, 1])  # wrap x and y; z isothermal
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    assert topo.elem_face_periodic.sum() == 2 * (2 * 3) + 2 * (2 * 3)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {1: -0.5, 6: 0.5}  # bottom/top z faces (Cartesian 3D attrs)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5)
    solver = SourceIterationSolver(ops, quad, tables, bcs)
    res = solver.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-9, atol=1e-13)


def test_gmsh_periodic_records_wire_in(tmp_path):
    """A gmsh 2.2 file with $Periodic node pairs pairs faces on load."""
    from pbte.mesh.gmsh_io import parse_gmsh_mesh

    # 2x1 quad strip on [0,2]x[0,1]; nodes 1..6; left edge (1,4), right (3,6)
    text = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
6
1 0 0 0
2 1 0 0
3 2 0 0
4 0 1 0
5 1 1 0
6 2 1 0
$EndNodes
$Elements
8
1 3 2 10 1 1 2 5 4
2 3 2 10 1 2 3 6 5
3 1 2 1 1 1 2
4 1 2 1 1 2 3
5 1 2 3 2 4 5
6 1 2 3 2 5 6
7 1 2 4 3 1 4
8 1 2 2 4 3 6
$EndElements
$Periodic
1
1 3 4
2
1 3
4 6
$EndPeriodic
"""
    m = parse_gmsh_mesh(text, source="inline")
    topo = pmesh.connect(m)
    assert topo.elem_face_periodic.sum() == 2
    e, lf = np.argwhere(topo.elem_face_periodic)[0]
    assert topo.elem_neighbor[e, lf] in (0, 1)
    assert abs(abs(topo.periodic_offset[e, lf, 0]) - 2.0) < 1e-12


def test_legacy_config_type4():
    from pbte.config import load_legacy_control

    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "Control.yaml")
        with open(p, "w") as f:
            f.write(
                "POLYDEG: 1\nSPATIAL_DIM: 2\nNAZIM: 8\nNSPEC: 4\n"
                "BOUNDARY_COND:\n  1: [1, -0.5]\n  3: [1, 0.5]\n"
                "  2: [4, 0.0]\n  4: [4, 0.0]\n"
            )
        rc = load_legacy_control(p)
    assert rc.bc_temps == {1: -0.5, 3: 0.5}
    assert sorted(rc.periodic_attrs) == [2, 4]


def test_native_baseline_rejects_periodic():
    from pbte import native

    m, topo, ops = _strip(nx=3, ny=2)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    with pytest.raises(NotImplementedError):
        native.cpp_source_iteration(ops, quad, tables, BCS, 2)
