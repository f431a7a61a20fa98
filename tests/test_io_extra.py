"""gmsh parser, legacy angular patterns, checkpoint/resume, VTU."""

import os

import numpy as np
import pytest

from pbte import mesh as pmesh
from pbte.angular import legacy_patterns, quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.solver.source_iteration import SourceIterationSolver

GMSH_CUBOID = "Reference Project/config/mesh/cuboid_2x2x2.msh"


def test_gmsh_parser(reference_root):
    path = reference_root / GMSH_CUBOID
    if not path.exists():
        pytest.skip("gmsh asset missing")
    m = pmesh.load_mesh(str(path))
    assert m.geom == "tet" and m.dim == 3
    # 2x2x2 cuboid with 6-tet split -> 48 tets
    assert m.num_elements == 48
    topo = pmesh.connect(m)
    # watertight: every boundary face tagged
    interior = topo.face_elems[:, 1] >= 0
    assert np.all(topo.face_attr[~interior] > 0)
    # physical names parsed
    assert len(m.physical_names) >= 6
    # total volume = 1 (unit cube scaled by nothing yet)
    vol = 0.0
    v = m.vertices[m.elem_verts]
    vol = np.abs(np.einsum("ei,ei->e", np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
                           v[:, 3] - v[:, 0]) / 6).sum()
    np.testing.assert_allclose(vol, 1.0, rtol=1e-10)


@pytest.mark.parametrize("dim,pattern,npole,nazim", [
    (2, 1, 1, 8), (2, 2, 1, 8), (3, 1, 4, 8), (3, 2, 4, 8),
])
def test_legacy_patterns(dim, pattern, npole, nazim):
    quad = legacy_patterns.build_legacy(dim, npole, nazim, pattern)
    assert quad.num_directions == npole * nazim
    # unit direction vectors
    np.testing.assert_allclose(
        np.linalg.norm(quad.directions[:, :dim], axis=1), 1.0, atol=1e-12
    )
    # totals close to the exact solid angle (legacy does not renormalize;
    # pattern 2's 3D polar rule integrates sin(theta) with Gauss error)
    expected = 2 * np.pi if dim == 2 else 4 * np.pi
    rtol = 1e-3 if (dim, pattern) == (3, 2) else 1e-6
    np.testing.assert_allclose(quad.total_weight, expected, rtol=rtol)
    # first moment vanishes by symmetry
    mom = np.einsum("k,kd->d", quad.weights, quad.directions)
    np.testing.assert_allclose(mom, 0.0, atol=1e-9)


def test_legacy_pattern_validation():
    with pytest.raises(ValueError):
        legacy_patterns.build_legacy(3, 3, 8, 1)  # npole odd
    with pytest.raises(ValueError):
        legacy_patterns.build_legacy(2, 1, 6, 1)  # nazim % 4 != 0
    with pytest.raises(ValueError):
        legacy_patterns.build_legacy(4, 2, 2, 1)  # bad dim


def test_checkpoint_roundtrip(tmp_path, reference_root):
    from pbte.io.checkpoint import load_checkpoint, save_checkpoint

    m = pmesh.load_mfem_mesh(str(reference_root / "config/mesh/unit-square-iso.mesh"))
    m = m.scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=3)
    solver = SourceIterationSolver(ops, quad, tables, {1: -0.5, 2: 0.5})

    # run 6 iterations straight
    r_full = solver.solve(tol=0, max_iter=6, verbose=False)

    # run 3, checkpoint, reload, run 3 more
    r_half = solver.solve(tol=0, max_iter=3, verbose=False)
    ckpt = str(tmp_path / "state.npz")
    save_checkpoint(ckpt, solver, r_half.u, r_half.Tc, r_half.Tv, 3, r_half.residual)
    state, it, res = load_checkpoint(ckpt, solver)
    assert it == 3
    r_resumed = solver.solve(tol=0, max_iter=3, verbose=False, state=state)

    np.testing.assert_allclose(
        np.asarray(r_resumed.Tc), np.asarray(r_full.Tc), rtol=1e-12, atol=1e-15
    )

    # fingerprint mismatch raises
    other = SourceIterationSolver(
        ops, quad, mat.build_tables(mat.SILICON, num_spectral=4), {1: -0.5, 2: 0.5}
    )
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        load_checkpoint(ckpt, other)


def test_legacy_control_yaml(reference_root):
    from pbte.config import load_run_config

    rc = load_run_config(
        str(reference_root / "Reference Project/config/control/Control.yaml")
    )
    assert rc.order == 3
    assert rc.angles.dimension == 3
    assert (rc.angles.polar_points, rc.angles.azimuth_points) == (16, 24)
    assert rc.n_spectral == 20 and rc.tolerance == 1e-7
    assert rc.bc_temps == {1: 0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: -0.5}
    assert rc.mesh_spec.endswith("cuboid_5x5x5.msh")
    assert rc.material.lattice_dist == 5.43e-10


def test_repo_config_assets():
    """The repo's own config/ mirrors the reference demo schema."""
    import os

    from pbte.config import load_run_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = load_run_config(os.path.join(root, "config/config.yaml"))
    assert rc.bc_temps == {1: -0.5, 2: 0.5}
    assert rc.angles.dimension == 2 and rc.angles.azimuth_points == 24
    assert rc.tolerance == 1e-7 and rc.max_iter == 101
    assert os.path.exists(os.path.join(root, rc.mesh_spec)) or os.path.exists(rc.mesh_spec)


def test_3d_slice_with_flux(tmp_path):
    """z-plane sampling of T and Q on a 3D solve (legacy output_3D_2Dslice_T_Q
    analog): hot top/cold bottom -> Qz < 0 on the midplane, Qx/Qy ~ 0 net."""
    from pbte.io.slice import write_3d_slice

    m = pmesh.make_cartesian_3d(2, 2, 2, pmesh.GEOM_HEX).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=4, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    solver = SourceIterationSolver(ops, quad, tables, bcs)
    res = solver.solve(tol=0, max_iter=30, verbose=False)
    Qc, _ = solver.heat_flux(res.u)
    T, Q = write_3d_slice(m, 1, res.Tc, Qc, z=0.5e-6,
                          path=str(tmp_path / "slice3d.txt"), nx=12, ny=12)
    assert not np.isnan(T).any() and not np.isnan(Q).any()
    assert Q[2].mean() < 0  # heat flows downward from the hot top
    # coarse angular sets leave some lateral flux noise; it must at least be
    # subdominant
    assert abs(Q[0].mean()) < abs(Q[2].mean())
    header = (tmp_path / "slice3d.txt").read_text().splitlines()[0]
    assert header.startswith("# nx 12 ny 12 z")


def test_3d_line_slice(tmp_path):
    """Axis line sampling (legacy output_3D_1Dslice_T_Q analog,
    ref: reference/PhononModel/NonGraySMRT.cpp:257-375): T along z between a
    cold bottom and hot top must be monotone-ish and bracketed; file format is
    'x y z T Qx Qy Qz'."""
    from pbte.io.slice import write_3d_line_slice

    m = pmesh.make_cartesian_3d(2, 2, 2, pmesh.GEOM_HEX).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=4, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    solver = SourceIterationSolver(ops, quad, tables, bcs)
    res = solver.solve(tol=0, max_iter=30, verbose=False)
    Qc, _ = solver.heat_flux(res.u)
    path = tmp_path / "line.txt"
    pts, T, Q = write_3d_line_slice(m, 1, res.Tc, Qc, axis=2,
                                    crd1=0.5e-6, crd2=0.5e-6,
                                    path=str(path), n=21)
    assert pts.shape == (21, 3) and not np.isnan(T).any()
    assert np.allclose(pts[:, 0], 0.5e-6) and np.allclose(pts[:, 1], 0.5e-6)
    assert T[0] < T[-1]  # cold bottom -> hot top
    # DG point values can overshoot the +-0.5 wall deviations (p=1, partially
    # converged) but must stay the same order of magnitude
    assert -1.0 <= T.min() <= T.max() <= 1.0
    lines = path.read_text().splitlines()
    assert lines[0] == "x y z T Qx Qy Qz"
    assert len(lines) == 22 and len(lines[1].split()) == 7
    with pytest.raises(ValueError):
        write_3d_line_slice(m, 1, res.Tc, Qc, axis=3, crd1=0, crd2=0,
                            path=str(path))


def test_vtu_high_order_subdivision(tmp_path):
    """lod-subdivided VTU must sample a p=2 DG field EXACTLY at the lattice
    points (the p>=2 field is no longer linearized; analog of the reference's
    SetHighOrderOutput, src/MacroscopicQuantities.cpp:168-271)."""
    import re

    from pbte.fem import reference as fref
    from pbte.io.vtu import write_vtu

    m = pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_QUAD)
    b = fref.basis(pmesh.GEOM_QUAD, 2)
    # nodal coefficients of f(x, y) = x^2 + 3y on each element
    nodes = b.nodes  # (D, 2) reference nodal points
    Xv = m.vertices[m.elem_verts]  # (ne, 4, 2)
    vshape = fref.vertex_shape(pmesh.GEOM_QUAD, nodes)  # (D, 4)
    phys = np.einsum("dv,evx->edx", vshape, Xv)  # (ne, D, 2)
    f = lambda p: p[..., 0] ** 2 + 3.0 * p[..., 1]
    coeffs = f(phys)  # (ne, D)

    path = write_vtu(m, 2, {"T": coeffs}, prefix=str(tmp_path / "ho"), lod=2)
    text = open(path).read()
    npts = int(re.search(r'NumberOfPoints="(\d+)"', text).group(1))
    ncells = int(re.search(r'NumberOfCells="(\d+)"', text).group(1))
    assert npts == 4 * 25 and ncells == 4 * 16  # 2 lods -> 25 pts/16 cells per elem

    pts_txt = (
        text.split("<Points>")[1]
        .split('format="ascii">')[1]
        .split("</DataArray>")[0]
    )
    pts = np.array(pts_txt.split(), dtype=float).reshape(-1, 3)
    vals_txt = text.split('Name="T"')[1].split(">")[1].split("<")[0]
    vals = np.array(vals_txt.split(), dtype=float)
    np.testing.assert_allclose(vals, f(pts[:, :2]), rtol=1e-12, atol=1e-12)


def test_vtu_lod0_backcompat(tmp_path):
    from pbte.io.vtu import write_vtu

    m = pmesh.make_cartesian_3d(2, 2, 2, pmesh.GEOM_TET)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    coeffs = np.random.default_rng(0).normal(size=(m.num_elements, ops.ndof))
    path = write_vtu(m, 1, {"T": coeffs}, prefix=str(tmp_path / "lin"), lod=0)
    text = open(path).read()
    assert f'NumberOfCells="{m.num_elements}"' in text


def test_2d_slice_tq(tmp_path):
    """Legacy output_2D_slice_T_Q analog: T and Q sampled on a 2D mesh."""
    from pbte.io.slice import write_2d_slice_tq

    m = pmesh.make_cartesian_2d(3, 3, pmesh.GEOM_TRIANGLE).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5})
    res = s.solve(tol=0, max_iter=10, verbose=False)
    Qc, _ = s.heat_flux(res.u)
    T, Q = write_2d_slice_tq(m, 1, np.asarray(res.Tc), np.asarray(Qc),
                             str(tmp_path / "tq.txt"), nx=20, ny=20)
    assert T.shape == (20, 20) and Q.shape == (2, 20, 20)
    assert np.isfinite(T).all() and np.isfinite(Q).all()
    rows = open(tmp_path / "tq.txt").readlines()
    assert rows[1].strip() == "x y T Qx Qy"
    assert len(rows) == 2 + 400


def test_paraview_collection(tmp_path):
    """Time-series .pvd collection mirrors the reference's
    ParaViewDataCollection layout (ref: src/MacroscopicQuantities.cpp:168-271
    + SetPrefixPath/cycle dirs): <root>/<name>/<name>.pvd indexing
    Cycle%06d/data.pvtu wrapping proc000000.vtu pieces."""
    import xml.etree.ElementTree as ET

    from pbte.io.vtu import ParaViewCollection

    m = pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_QUAD)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    rng = np.random.default_rng(1)
    coll = ParaViewCollection(m, 1, name="pbte_fields", root=str(tmp_path))
    for cyc in (0, 25):
        T = rng.normal(size=(m.num_elements, ops.ndof))
        Q = rng.normal(size=(2, m.num_elements, ops.ndof))
        pvd = coll.save({"T": T}, {"Q": Q}, cycle=cyc, time=float(cyc))
    root = ET.parse(pvd).getroot()
    assert root.get("type") == "Collection"
    sets = root.findall(".//DataSet")
    assert [d.get("file") for d in sets] == [
        "Cycle000000/data.pvtu", "Cycle000025/data.pvtu"
    ]
    assert [float(d.get("timestep")) for d in sets] == [0.0, 25.0]
    for cyc in (0, 25):
        cdir = tmp_path / "pbte_fields" / f"Cycle{cyc:06d}"
        pv = ET.parse(cdir / "data.pvtu").getroot()
        assert pv.find(".//Piece").get("Source") == "proc000000.vtu"
        names = [a.get("Name") for a in pv.findall(".//PPointData/PDataArray")]
        assert names == ["T", "Q"]
        vt = ET.parse(cdir / "proc000000.vtu").getroot()
        arr = [a.get("Name") for a in vt.findall(".//PointData/DataArray")]
        assert arr == ["T", "Q"]


def test_cli_vtu_every(tmp_path):
    """--vtu-every writes collection cycles during the solve plus a final
    cycle, and the supercell-aware Tc path feeds fine-element coefficients."""
    import subprocess
    import sys as _sys

    out = tmp_path / "out"
    r = subprocess.run(
        [_sys.executable, "-m", "pbte.cli", "-m", "unit-square-quad",
         "-o", "1", "--max-iter", "6", "--vtu-every", "3",
         "--no-dumps", "--out", str(out)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": os.path.dirname(os.path.dirname(
                 os.path.abspath(__file__)))},
        cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    pvd = out / "vis" / "pbte_fields" / "pbte_fields.pvd"
    assert pvd.exists(), r.stdout + r.stderr[-2000:]
    text = pvd.read_text()
    assert "Cycle000003/data.pvtu" in text and "Cycle000006/data.pvtu" in text


def _parse_vtu_array(path, name):
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    for arr in root.findall(".//PointData/DataArray"):
        if arr.get("Name") == name:
            return np.fromstring(arr.text, sep=" ")
    raise KeyError(name)


def test_write_pvtu_partitioned(tmp_path):
    """Distributed field export: one .vtu piece
    per partition + .pvtu index, matching the reference's parallel
    WriteParaView per-rank pieces (ref: src/MacroscopicQuantities.cpp:168-271).
    Piece point-data must equal the basis evaluation of each partition's
    local coefficient block."""
    import xml.etree.ElementTree as ET

    from pbte.fem import reference as fref
    from pbte.io.vtu import write_pvtu

    m = pmesh.make_cartesian_2d(4, 4, pmesh.GEOM_QUAD)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    rng = np.random.default_rng(3)
    T = rng.normal(size=(m.num_elements, ops.ndof))
    Q = rng.normal(size=(2, m.num_elements, ops.ndof))
    part = (np.arange(m.num_elements) % 3).astype(np.int32)
    pieces = [
        (ids, {"T": T[ids]}, {"Q": Q[:, ids]})
        for p in range(3)
        for ids in (np.flatnonzero(part == p),)
    ]
    path = write_pvtu(m, 1, pieces, prefix=str(tmp_path / "fields"), lod=0)
    root = ET.parse(path).getroot()
    srcs = [p.get("Source") for p in root.findall(".//Piece")]
    assert srcs == [f"fields.{p:06d}.vtu" for p in range(3)]
    shape = fref.basis(pmesh.GEOM_QUAD, 1).eval(
        fref.REF_VERTS[pmesh.GEOM_QUAD])  # (4, 4)
    total_cells = 0
    for p in range(3):
        piece = tmp_path / f"fields.{p:06d}.vtu"
        ids = np.flatnonzero(part == p)
        vals = _parse_vtu_array(piece, "T")
        expect = np.einsum("ei,pi->ep", T[ids], shape).reshape(-1)
        assert np.allclose(vals, expect, atol=1e-12)
        total_cells += len(ids)
        txt = piece.read_text()
        assert f'NumberOfCells="{len(ids)}"' in txt
    assert total_cells == m.num_elements


def test_paraview_collection_partitioned(tmp_path):
    """ParaViewCollection(part=...) writes proc%06d.vtu pieces per cycle and
    the .pvtu indexes all of them."""
    import xml.etree.ElementTree as ET

    from pbte.io.vtu import ParaViewCollection

    m = pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_QUAD)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    part = np.array([0, 0, 1, 1], dtype=np.int32)
    coll = ParaViewCollection(m, 1, name="f", root=str(tmp_path), part=part)
    T = np.random.default_rng(0).normal(size=(4, ops.ndof))
    pvd = coll.save({"T": T}, cycle=7)
    assert (tmp_path / "f" / "f.pvd").exists()
    cdir = tmp_path / "f" / "Cycle000007"
    pv = ET.parse(cdir / "data.pvtu").getroot()
    srcs = [p.get("Source") for p in pv.findall(".//Piece")]
    assert srcs == ["proc000000.vtu", "proc000001.vtu"]
    for p in range(2):
        vals = _parse_vtu_array(cdir / f"proc{p:06d}.vtu", "T")
        assert len(vals) == 2 * 4  # 2 elements x 4 corners
