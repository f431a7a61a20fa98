"""Mixed-geometry (2D triangle+quad) meshes: connectivity, assembly, solve.

The reference's MFEM tree inherits mixed-element support from
mfem::Mesh/FiniteElementSpace (any conforming mix loads and assembles); the
legacy tree is single-geometry. Here mixed meshes are flat SoA like
everything else: per-element geometry codes, -1-padded vertex/face slots,
operators padded to the widest member basis (fem/assembly.py
_assemble_mixed docstring).

Oracle strategy: (a) an all-one-geometry "mixed" mesh must reproduce the
plain single-geometry pipeline ARRAY-EXACTLY (both paths use the same
first-seen face numbering and per-element face-id sort); (b) on genuinely
mixed meshes the DG identities (divergence, coupling transpose-symmetry)
pin the cross-geometry face integrals; (c) the batched solver must match
the sequential numpy oracle element-wise.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.mesh import core as mesh_core
from pbte.solver.source_iteration import SourceIterationSolver
from pbte.validation.oracle import solve_oracle

BCS = {1: -0.5, 2: 0.5, 3: 0.25, 4: -0.25}


def test_mixed_connect_invariants():
    m = pmesh.make_mixed_2d(4, 3)
    assert m.geom == mesh_core.GEOM_MIXED
    # 2 quad columns * 3 rows + 2 tri columns * 3 rows * 2
    assert m.num_elements == 6 + 12
    topo = pmesh.connect(m)
    ef, nbr = topo.elem_face, topo.elem_neighbor
    valid = ef >= 0
    # padded slots: no face, no neighbor, no attr, zero normal
    assert (nbr[~valid] == -1).all()
    assert (topo.elem_face_attr[~valid] == 0).all()
    assert np.allclose(topo.normals[~valid], 0.0)
    # real slots: unit outward normals
    assert np.allclose(
        np.linalg.norm(topo.normals[valid], axis=-1), 1.0
    )
    # neighbor symmetry through shared global face ids
    for e in range(m.num_elements):
        for f in range(ef.shape[1]):
            n2 = nbr[e, f]
            if n2 >= 0:
                slot = np.flatnonzero(ef[n2] == ef[e, f])
                assert len(slot) == 1 and nbr[n2, slot[0]] == e
    # triangles occupy 3 slots, quads 4
    tri = m.elem_geom == mesh_core.MFEM_CODE_OF_GEOM[mesh_core.GEOM_TRIANGLE]
    assert (valid.sum(axis=1) == np.where(tri, 3, 4)).all()
    # every boundary side is attributed
    assert sorted(set(topo.elem_face_attr[topo.elem_face_attr > 0])) == [
        1, 2, 3, 4,
    ]


def _as_mixed(m):
    """Re-tag a single-geometry 2D mesh as geom='mixed' (same elements)."""
    code = mesh_core.MFEM_CODE_OF_GEOM[m.geom]
    return dataclasses.replace(
        m,
        geom=mesh_core.GEOM_MIXED,
        elem_geom=np.full(m.num_elements, code, dtype=np.int32),
    )


@pytest.mark.parametrize("geom", ["triangle", "quad"])
@pytest.mark.parametrize("face_mode", ["mfem-parity", "consistent"])
def test_all_one_geometry_mixed_matches_plain(geom, face_mode):
    m = pmesh.make_cartesian_2d(3, 2, geom)
    topo_plain = pmesh.connect(m)
    topo_mixed = pmesh.connect(_as_mixed(m))
    np.testing.assert_array_equal(topo_plain.elem_face, topo_mixed.elem_face)
    np.testing.assert_array_equal(
        topo_plain.elem_neighbor, topo_mixed.elem_neighbor
    )
    np.testing.assert_allclose(topo_plain.normals, topo_mixed.normals)
    a = assembly.assemble(topo_plain, order=2, face_mode=face_mode)
    b = assembly.assemble(topo_mixed, order=2, face_mode=face_mode)
    for name in (
        "basis_int", "mass", "stiff", "face_mass", "face_int", "coupling"
    ):
        np.testing.assert_allclose(
            getattr(a, name), getattr(b, name), atol=1e-14,
            err_msg=name,
        )


@pytest.mark.parametrize("order", [1, 2])
def test_mixed_divergence_identity(order):
    """stiff[d] + stiff[d]^T = sum_f n_{f,d} face_mass_f on every element —
    holds per element for the consistent face mode (padded dof rows are zero
    on both sides; the identity-padded mass is not involved)."""
    m = pmesh.make_mixed_2d(4, 3, sx=1.3, sy=0.7)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    for d in range(2):
        lhs = ops.stiff[:, d] + np.swapaxes(ops.stiff[:, d], -1, -2)
        rhs = np.einsum("ef,efij->eij", ops.normals[:, :, d], ops.face_mass)
        np.testing.assert_allclose(lhs, rhs, atol=1e-12)


def test_mixed_coupling_transpose_symmetry():
    """coupling[e,f]_{ij} = int phi_i^e phi_j^nbr must equal
    coupling[nbr,f']^T on the shared face — including tri<->quad faces,
    where it pins the cross-geometry neighbor-basis integration."""
    m = pmesh.make_mixed_2d(4, 2)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=2, face_mode="consistent")
    egeom = m.elem_geom
    cross_checked = 0
    for e in range(m.num_elements):
        for f in range(ops.faces_per_elem):
            n2 = ops.neighbor[e, f]
            if n2 < 0:
                continue
            f2 = int(np.flatnonzero(topo.elem_face[n2] == topo.elem_face[e, f])[0])
            np.testing.assert_allclose(
                ops.coupling[e, f],
                ops.coupling[n2, f2].T,
                atol=1e-13,
            )
            if egeom[e] != egeom[n2]:
                cross_checked += 1
    assert cross_checked > 0  # the tri/quad interface was actually exercised


def _total_area(m):
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=0 + 1, face_mode="consistent")
    return ops.basis_int.sum()  # p>=1 basis partitions unity per element


def test_mixed_mfem_roundtrip(tmp_path):
    m = pmesh.make_mixed_2d(4, 3)
    path = str(tmp_path / "mixed.mesh")
    pmesh.write_mfem_mesh(m, path)
    m2 = pmesh.load_mfem_mesh(path)
    assert m2.geom == mesh_core.GEOM_MIXED
    np.testing.assert_array_equal(m.elem_geom, m2.elem_geom)
    np.testing.assert_array_equal(m.elem_verts, m2.elem_verts)
    np.testing.assert_allclose(m.vertices, m2.vertices)
    np.testing.assert_array_equal(m.bdry_attr, m2.bdry_attr)


def test_mixed_gmsh_parse(tmp_path):
    """Hand-written 2-element gmsh v2 file: one quad + one triangle
    sharing an edge (gmsh types 3 and 2)."""
    text = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
5 2 0.5 0
$EndNodes
$Elements
6
1 3 2 1 1 1 2 3 4
2 2 2 1 1 2 5 3
3 1 2 7 1 1 2
4 1 2 7 1 2 5
5 1 2 8 1 5 3
6 1 2 8 1 3 4
$EndElements
"""
    p = tmp_path / "mix.msh"
    p.write_text(text)
    from pbte.mesh.gmsh_io import load_gmsh_mesh

    m = load_gmsh_mesh(str(p))
    assert m.geom == mesh_core.GEOM_MIXED
    assert m.num_elements == 2
    topo = pmesh.connect(m)
    # the shared edge (2,3) is interior
    assert (topo.elem_neighbor >= 0).sum() == 2
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    np.testing.assert_allclose(ops.basis_int.sum(), 1.5, rtol=1e-12)


def test_mixed_uniform_refine():
    m = pmesh.make_mixed_2d(2, 2, sx=1.5)
    r = pmesh.uniform_refine(m, 1)
    assert r.geom == mesh_core.GEOM_MIXED
    assert r.num_elements == 4 * m.num_elements
    np.testing.assert_array_equal(r.elem_geom, np.repeat(m.elem_geom, 4))
    # conforming: connect succeeds, interior faces shared, area preserved
    topo = pmesh.connect(r)
    assert (topo.elem_neighbor >= 0).any()
    np.testing.assert_allclose(_total_area(r), 1.5, rtol=1e-12)
    # child areas sum to 1.5 and the refined mesh still solves
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    for d in range(2):
        lhs = ops.stiff[:, d] + np.swapaxes(ops.stiff[:, d], -1, -2)
        rhs = np.einsum("ef,efij->eij", ops.normals[:, :, d], ops.face_mass)
        np.testing.assert_allclose(lhs, rhs, atol=1e-12)


def test_mixed_sample_and_vtu(tmp_path):
    """Point sampling and VTU subdivision output on a mixed solve."""
    from pbte.fem import reference as fem_ref
    from pbte.io.slice import sample_field
    from pbte.io.vtu import write_vtu

    m = pmesh.make_mixed_2d(4, 3).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=2,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=2, polar_points=24, azimuth_points=8)
    )
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    solver = SourceIterationSolver(ops, quad, tables, BCS)
    res = solver.solve(tol=0, max_iter=5, verbose=False)
    Tc = np.asarray(res.Tc)

    # sample at element centroids; oracle = direct own-basis evaluation
    topo = pmesh.connect(m)
    vals = sample_field(m, 2, Tc, topo.centroids)
    assert not np.isnan(vals).any()
    for e in [0, m.num_elements - 1]:  # one quad, one triangle
        g = mesh_core.MFEM_GEOM_CODES[int(m.elem_geom[e])]
        b = fem_ref.basis(g, 2)
        Xv = m.vertices[[v for v in m.elem_verts[e] if v >= 0]]
        r = assembly.inverse_map(g, Xv[None], topo.centroids[e][None, None])[0]
        direct = float(b.eval(r)[0] @ Tc[e, : b.ndof])
        np.testing.assert_allclose(vals[e], direct, rtol=1e-12)

    path = write_vtu(m, 2, {"T": Tc}, prefix=str(tmp_path / "mix"), lod=1)
    text = open(path).read()
    tri = (m.elem_geom == mesh_core.MFEM_CODE_OF_GEOM[
        mesh_core.GEOM_TRIANGLE]).sum()
    nquad = m.num_elements - tri
    # lod=1: each tri -> 4 tri subcells (type 5), quad -> 4 quad (type 9)
    ncells = 4 * m.num_elements
    assert f'NumberOfCells="{ncells}"' in text
    types = text.split('Name="types"')[1].split("\n")[1].split()
    import collections

    cnt = collections.Counter(types)
    assert cnt["5"] == 4 * tri and cnt["9"] == 4 * nquad


@pytest.mark.slow
def test_cli_mixed_builtin(tmp_path):
    """End-to-end CLI run on the mixed builtin mesh."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "pbte.cli", "--platform", "cpu",
         "-m", "unit-square-mixed", "-o", "2", "--face-mode", "consistent",
         "--max-iter", "4", "--tol", "0", "--vtu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=480,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "output/log/Tc_all.txt").exists()
    assert (tmp_path / "output/2D/results/T_slice.txt").exists()
    T = np.loadtxt(tmp_path / "output/2D/results/T_slice.txt", skiprows=2)
    assert not np.isnan(T[:, 2]).any()


def test_mixed_padded_dofs_stay_zero_and_solver_matches_oracle():
    m = pmesh.make_mixed_2d(4, 3).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=2,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=2, polar_points=24, azimuth_points=8)
    )
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    uo, Tco, _, _, _ = solve_oracle(ops, quad, tables, BCS, tol=0, max_iter=4)

    solver = SourceIterationSolver(ops, quad, tables, BCS)
    u, Tc, Tv = solver.initial_state()
    prev = Tv
    for _ in range(4):
        u, Tc, prev, _ = solver.step(u, Tc, prev)

    ub = solver.u_by_direction(u)
    np.testing.assert_allclose(ub, uo, rtol=1e-10, atol=1e-22)
    np.testing.assert_allclose(np.asarray(Tc), Tco, rtol=1e-10, atol=1e-14)
    # triangle padded dofs (beyond ndof=6 at p=2) are exactly zero
    tri = m.elem_geom == mesh_core.MFEM_CODE_OF_GEOM[mesh_core.GEOM_TRIANGLE]
    assert np.all(ub[:, :, tri, 6:] == 0.0)
    assert np.all(np.asarray(Tc)[tri, 6:] == 0.0)
    assert not np.all(ub[:, :, tri, :6] == 0.0)


# ---------------------------------------------------------------------------
# 3D mixed geometry: tet + hex + prism + pyramid
# (the builtin "unit-cube-mixed" contains all four in one conforming mesh;
# "unit-cube-prism" is the pure-wedge cube split, which also routes through
# the mixed pipeline because a wedge's own faces mix triangle/quad shapes)
# ---------------------------------------------------------------------------

BCS3 = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}


def _divergence_and_coupling_checks(m, ops, topo):
    lhs = ops.stiff + np.swapaxes(ops.stiff, -1, -2)
    rhs = np.einsum("efd,efij->edij", ops.normals, ops.face_mass)
    assert np.abs(lhs - rhs).max() / np.abs(rhs).max() < 1e-9
    nbr = topo.elem_neighbor
    for e in range(m.num_elements):
        for f in range(topo.faces_per_elem):
            n = nbr[e, f]
            if n < 0 or topo.elem_face_periodic[e, f]:
                continue
            fp = int(np.nonzero(nbr[n] == e)[0][0])
            a_, b_ = ops.coupling[e, f], ops.coupling[n, fp].T
            assert np.abs(a_ - b_).max() <= 1e-11 * max(
                np.abs(a_).max(), 1e-300
            ), (e, f)


def test_prism_pyramid_reference_exactness():
    """Volume quadrature exactness against closed-form monomial integrals:
    prism  int x^a y^b z^c = a! b! / (a+b+2)! / (c+1);
    pyramid (apex (0,0,1), Duffy-collapsed with the (1-w)^2 Jacobi weight)
            int x^a y^b z^c = 1/((a+1)(b+1)) * B(c+1, a+b+3)."""
    from math import factorial

    from scipy.special import beta

    from pbte.fem import quadrature as fquad

    for p in (1, 2, 3):
        deg = 2 * p + 1
        vp, vw = fquad.volume_rule(mesh_core.GEOM_PRISM, deg)
        for (a, b, c) in [(0, 0, 0), (1, 1, 1), (p, p, 1), (2 * p - 1, 1, 1)]:
            if a + b + c > deg:
                continue
            got = float((vw * vp[:, 0] ** a * vp[:, 1] ** b
                         * vp[:, 2] ** c).sum())
            want = factorial(a) * factorial(b) / factorial(a + b + 2) / (c + 1)
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-16)
        vp, vw = fquad.volume_rule(mesh_core.GEOM_PYRAMID, deg)
        for (a, b, c) in [(0, 0, 0), (1, 0, 1), (p, 1, p), (1, 2 * p - 1, 1)]:
            if a + b + c > deg:
                continue
            got = float((vw * vp[:, 0] ** a * vp[:, 1] ** b
                         * vp[:, 2] ** c).sum())
            want = 1.0 / ((a + 1) * (b + 1)) * beta(c + 1, a + b + 3)
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-16)
        # nodal bases are unisolvent for both new geometries
        from pbte.fem import reference as fem_ref

        for g in (mesh_core.GEOM_PRISM, mesh_core.GEOM_PYRAMID):
            bs = fem_ref.basis(g, p)
            np.testing.assert_allclose(
                bs.eval(bs.nodes), np.eye(bs.ndof), atol=1e-8
            )


def test_mixed3d_connect_and_assembly_invariants():
    m = pmesh.load_builtin("unit-cube-mixed")
    assert m.geom == mesh_core.GEOM_MIXED
    assert sorted(
        mesh_core.MFEM_GEOM_CODES[int(c)] for c in np.unique(m.elem_geom)
    ) == ["hex", "prism", "pyramid", "tet"]
    topo = pmesh.connect(m)
    nbr = topo.elem_neighbor
    for e in range(m.num_elements):
        for f in range(topo.faces_per_elem):
            n = nbr[e, f]
            if n >= 0:
                assert e in nbr[n]
    valid = np.abs(topo.normals).sum(-1) > 0
    np.testing.assert_allclose(
        np.linalg.norm(topo.normals[valid], axis=-1), 1.0
    )
    # all six box boundary attrs present
    assert set(np.unique(topo.elem_face_attr)) == {0, 1, 2, 3, 4, 5, 6}
    ops = assembly.assemble(topo, order=2, face_mode="consistent")
    np.testing.assert_allclose(ops.basis_int.sum(), 1.0, rtol=1e-12)
    _divergence_and_coupling_checks(m, ops, topo)


def test_prism_builtin_assembly_invariants():
    m = pmesh.load_builtin("unit-cube-prism")
    assert m.geom == mesh_core.GEOM_MIXED  # pure wedge routes through mixed
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    np.testing.assert_allclose(ops.basis_int.sum(), 1.0, rtol=1e-12)
    _divergence_and_coupling_checks(m, ops, topo)


def test_mixed3d_refine_conforming_and_positive():
    """Red refinement of all four 3D geometries: pyramid children GROW the
    mix (6 pyramids + 4 tets), prisms split 8-way, volumes are conserved,
    and every child has a positive Jacobian — this test also guards the
    tet octahedron-children orientation fix (children 5/7 of the Bey split
    were negatively oriented; the point sets tile either way, so only
    signed volumes catch it)."""
    m0 = pmesh.load_builtin("unit-cube-mixed")
    m = pmesh.uniform_refine(m0, 1)
    # 1 hex->8, 5 pyramids->5*(6 pyr + 4 tet), 2 tets->16, 2 prisms->16
    assert m.num_elements == 8 + 5 * 10 + 16 + 16
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    vols = ops.basis_int.sum(axis=1)
    assert (vols > 0).all()
    np.testing.assert_allclose(vols.sum(), 1.0, rtol=1e-12)
    _divergence_and_coupling_checks(m, ops, topo)
    # single-geometry tet refinement: same orientation guard
    mt = pmesh.uniform_refine(pmesh.make_cartesian_3d(2, 2, 2, "tet"), 1)
    ot = assembly.assemble(pmesh.connect(mt), order=1,
                           face_mode="consistent")
    assert (ot.basis_int.sum(axis=1) > 0).all()
    np.testing.assert_allclose(ot.basis_int.sum(), 1.0, rtol=1e-12)


def test_mixed3d_solver_matches_oracle():
    m = pmesh.load_builtin("unit-cube-mixed").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=2,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    uo, Tco, _, _, _ = solve_oracle(ops, quad, tables, BCS3, tol=0,
                                    max_iter=5)
    solver = SourceIterationSolver(ops, quad, tables, BCS3)
    res = solver.solve(tol=0, max_iter=5, verbose=False)
    Tc = np.asarray(res.Tc)
    np.testing.assert_allclose(Tc, Tco, rtol=1e-10, atol=1e-14)
    # padded dofs of the narrower geometries stay exactly zero
    ub = solver.u_by_direction(res.u)
    from pbte.fem import reference as fem_ref

    for code in np.unique(m.elem_geom):
        g = mesh_core.MFEM_GEOM_CODES[int(code)]
        Dg = fem_ref.basis(g, 2).ndof
        sel = m.elem_geom == code
        assert np.all(ub[:, :, sel, Dg:] == 0.0), g
        assert np.all(Tc[sel, Dg:] == 0.0), g


def test_mixed3d_mfem_roundtrip(tmp_path):
    m = pmesh.load_builtin("unit-cube-mixed")
    path = str(tmp_path / "mixed3d.mesh")
    pmesh.write_mfem_mesh(m, path)
    m2 = pmesh.load_mfem_mesh(path)
    assert m2.geom == mesh_core.GEOM_MIXED
    np.testing.assert_array_equal(m.elem_geom, m2.elem_geom)
    np.testing.assert_array_equal(m.elem_verts, m2.elem_verts)
    np.testing.assert_allclose(m.vertices, m2.vertices)
    np.testing.assert_array_equal(np.sort(m.bdry_attr), np.sort(m2.bdry_attr))


def test_mixed3d_gmsh_parse(tmp_path):
    """Hand-written gmsh v2 file: one prism (type 6) + one pyramid (type 7)
    sharing the prism's quad side face."""
    text = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
8
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
5 1 0 1
6 0 1 1
7 2 0 0.2
8 2 0 0.8
$EndNodes
$Elements
4
1 6 2 1 1 1 2 3 4 5 6
2 7 2 1 1 1 2 5 4 7
3 2 2 7 1 1 3 2
4 3 2 8 1 4 5 6 4
$EndElements
"""
    p = tmp_path / "mix3d.msh"
    p.write_text(text)
    from pbte.mesh.gmsh_io import load_gmsh_mesh

    m = load_gmsh_mesh(str(p))
    assert m.geom == mesh_core.GEOM_MIXED
    assert m.num_elements == 2
    assert [int(c) for c in m.elem_geom] == [
        mesh_core.MFEM_CODE_OF_GEOM[mesh_core.GEOM_PRISM],
        mesh_core.MFEM_CODE_OF_GEOM[mesh_core.GEOM_PYRAMID],
    ]
    topo = pmesh.connect(m)
    # the prism's (v0,v1,v4,v3) quad side = the pyramid's base: interior
    assert (topo.elem_neighbor >= 0).sum() == 2


def test_mixed3d_sample_and_vtu(tmp_path):
    """Point location inside prisms/pyramids + VTU cell types 13/14."""
    from pbte.io.slice import sample_field
    from pbte.io.vtu import write_vtu

    m = pmesh.load_builtin("unit-cube-mixed")
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    # a LINEAR field is exactly representable at p=1 on every member
    # geometry: project f(x)=2x - 3y + z by nodal interpolation
    from pbte.fem import reference as fem_ref

    coeffs = np.zeros((m.num_elements, ops.ndof))
    for e in range(m.num_elements):
        g = mesh_core.MFEM_GEOM_CODES[int(m.elem_geom[e])]
        b = fem_ref.basis(g, 1)
        nv = mesh_core.GEOM_NV[g]
        Xv = m.vertices[m.elem_verts[e][:nv]]
        sh = fem_ref.vertex_shape(g, b.nodes)  # (D, nv)
        X = sh @ Xv  # physical node coords
        coeffs[e, : b.ndof] = 2 * X[:, 0] - 3 * X[:, 1] + X[:, 2]
    rng = np.random.default_rng(7)
    pts = rng.random((200, 3)) * 0.98 + 0.01
    vals = sample_field(m, 1, coeffs, pts)
    assert not np.isnan(vals).any()
    np.testing.assert_allclose(
        vals, 2 * pts[:, 0] - 3 * pts[:, 1] + pts[:, 2], atol=1e-9
    )

    path = write_vtu(m, 1, {"f": coeffs}, prefix=str(tmp_path / "mix3d"))
    text = open(path).read()
    types = set(text.split('Name="types"')[1].split("\n")[1].split())
    assert {"10", "12", "13", "14"} <= types  # tet, hex, wedge, pyramid


def test_mixed3d_periodic_prism_matches_oracle():
    """Periodic wiring on a mixed-3D mesh: the prism builtin's quad x-faces
    pair through make_periodic's vertex maps, and the -1-padded face-vertex
    rows must survive _wire_periodic's key/centroid computations. Lagged
    periodic coupling then matches the sequential oracle exactly."""
    m = pmesh.make_cartesian_3d(3, 3, 3, "prism").scaled(1e-6)
    m = pmesh.make_periodic(m, [0])
    topo = pmesh.connect(m)
    assert topo.elem_face_periodic.sum() == 18  # 3x3 quad faces, both sides
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {1: -0.5, 2: -0.5, 4: -0.5, 6: 0.5}  # x faces are periodic now
    s = SourceIterationSolver(ops, quad, tables, bcs)
    assert s.has_periodic
    r = s.solve(tol=0, max_iter=4, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=4)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)
