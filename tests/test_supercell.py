"""Supercell merge (fem/supercell.py): simplex lattices as block lattices.

The 6-tet / 2-tri splits of Cartesian lattices are merged into macro-cell
super elements and swept with the shift-structured lattice ring; the block
solve must reproduce the fine-mesh sweep EXACTLY (same linear systems,
solved simultaneously; ref semantics src/PBTESolver.cpp:208-332). Every
test compares full iterate trajectories against the general scan path on
the raw fine ops in float64.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbte import mesh as pmesh  # noqa: E402
from pbte.angular import quadrature as ang  # noqa: E402
from pbte.fem import assembly, supercell  # noqa: E402
from pbte.material import nongray_smrt as mat  # noqa: E402
from pbte.solver.source_iteration import SourceIterationSolver  # noqa: E402

TABLES = mat.build_tables(mat.SILICON, num_spectral=3)


def _run(mesh, quad, bcs, order, nsteps=4, **kw):
    ops = assembly.assemble(
        pmesh.connect(mesh), order=order, face_mode="consistent"
    )
    s = SourceIterationSolver(
        ops, quad, TABLES, bcs, dtype=jnp.float64, **kw
    )
    u, Tc, Tv = s.initial_state()
    hist = []
    prev = Tv
    for _ in range(nsteps):
        u, Tc, Tv2, r = s.step(u, Tc, prev)
        prev = Tv2
        hist.append(float(r))
    return s, u, Tc, prev, hist


def test_detect_tri_lattice():
    m = pmesh.make_cartesian_2d(4, 3, "triangle")
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    ops = assembly.permute_faces(ops, assembly.canonical_face_perm(ops))
    cls = assembly.element_classes(ops)
    sc = supercell.detect(ops, cls)
    assert sc is not None
    assert sc.gsz == 2 and sc.ncell == 12
    assert sc.super_ops.ndof == 2 * ops.ndof
    assert sc.super_ops.faces_per_elem == 4
    assert sorted(sc.lat_dims) == [3, 4]
    # every fine element appears exactly once in the block map
    assert np.array_equal(np.sort(sc.elem_at.reshape(-1)), np.arange(24))


def test_detect_six_tet_lattice():
    m = pmesh.make_cartesian_3d(3, 2, 2, "tet")
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    ops = assembly.permute_faces(ops, assembly.canonical_face_perm(ops))
    cls = assembly.element_classes(ops)
    sc = supercell.detect(ops, cls)
    assert sc is not None
    assert sc.gsz == 6 and sc.ncell == 12
    assert sc.int_normals.shape[0] == 12  # 6 intra faces x 2 sides
    assert sc.super_ops.faces_per_elem == 6
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=4, azimuth_points=8)
    )
    assert supercell.verify_acyclic(sc, quad.directions)


def test_detect_rejects_hex():
    m = pmesh.make_cartesian_3d(2, 2, 2, "hex")
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    ops = assembly.permute_faces(ops, assembly.canonical_face_perm(ops))
    assert supercell.detect(ops, assembly.element_classes(ops)) is None


def test_tri_lattice_iterate_exact():
    m = pmesh.make_cartesian_2d(4, 3, "triangle")
    quad = ang.build(
        ang.AngularOptions(dimension=2, polar_points=1, azimuth_points=8)
    )
    bcs = {1: -0.5, 2: 0.0, 3: 0.5, 4: 0.0}
    s_ref, u_r, Tc_r, Tv_r, h_r = _run(
        m, quad, bcs, 1, sweep_mode="scan", supercell="off"
    )
    s_sup, u_s, Tc_s, Tv_s, h_s = _run(
        m, quad, bcs, 1, sweep_mode="ring", supercell="on"
    )
    assert s_sup._super is not None and s_sup.sweep_mode == "ring"
    assert s_sup.G == 4  # quadrant sign patterns only
    np.testing.assert_allclose(h_s, h_r, rtol=1e-12)
    scale = np.abs(np.asarray(Tc_r)).max()
    assert (
        np.abs(s_sup.Tc_fine(Tc_s) - np.asarray(Tc_r)).max() < 1e-13 * scale
    )
    np.testing.assert_allclose(
        np.asarray(Tv_s), np.asarray(Tv_r), rtol=0, atol=1e-13 * scale
    )
    ud_r = s_ref.u_by_direction(u_r)
    ud_s = s_sup.u_by_direction(u_s)
    assert np.abs(ud_s - ud_r).max() < 1e-13 * np.abs(ud_r).max()


@pytest.mark.parametrize("order", [1, 2])
def test_six_tet_iterate_exact(order):
    m = pmesh.make_cartesian_3d(3, 2, 2, "tet").scaled(1e-6)
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=4, azimuth_points=4)
    )
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    s_ref, u_r, Tc_r, Tv_r, h_r = _run(
        m, quad, bcs, order, sweep_mode="scan", supercell="off"
    )
    s_sup, u_s, Tc_s, Tv_s, h_s = _run(
        m, quad, bcs, order, sweep_mode="ring", supercell="on"
    )
    assert s_sup._super is not None and s_sup.sweep_mode == "ring"
    assert s_sup.G == 8  # octant groups, not the 24 fine signature groups
    assert s_sup.D == 6 * s_ref.D
    np.testing.assert_allclose(h_s, h_r, rtol=1e-11)
    scale = np.abs(np.asarray(Tc_r)).max()
    assert (
        np.abs(s_sup.Tc_fine(Tc_s) - np.asarray(Tc_r)).max() < 1e-12 * scale
    )
    ud_r = s_ref.u_by_direction(u_r)
    ud_s = s_sup.u_by_direction(u_s)
    assert np.abs(ud_s - ud_r).max() < 1e-12 * np.abs(ud_r).max()
    Qc_r, Qv_r = s_ref.heat_flux(u_r)
    Qc_s, Qv_s = s_sup.heat_flux(u_s)
    qs = np.abs(np.asarray(Qv_r)).max()
    assert np.abs(np.asarray(Qv_s) - np.asarray(Qv_r)).max() < 1e-12 * qs
    assert (
        np.abs(np.asarray(Qc_s) - np.asarray(Qc_r)).max()
        < 1e-12 * np.abs(np.asarray(Qc_r)).max()
    )


def test_six_tet_oracle_convergence():
    """Converged solve through the supercell ring equals the sequential
    reference-mirror oracle (validation/oracle.py) on the fine mesh."""
    from pbte.validation import oracle

    m = pmesh.make_cartesian_3d(2, 2, 2, "tet").scaled(1e-6)
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    conn = pmesh.connect(m)
    ops = assembly.assemble(conn, order=1, face_mode="consistent")
    s = SourceIterationSolver(
        ops, quad, TABLES, bcs, dtype=jnp.float64,
        sweep_mode="ring", supercell="on",
    )
    assert s._super is not None
    res = s.solve(tol=1e-10, max_iter=200, verbose=False)
    _u, Tc_o, _tv, _res, _it = oracle.solve_oracle(
        ops, quad, TABLES, bcs, tol=1e-10, max_iter=200
    )
    scale = np.abs(Tc_o).max()
    assert np.abs(s.Tc_fine(res.Tc) - Tc_o).max() < 1e-9 * scale


def test_forced_ring_unsupported_bcs_fall_back():
    """Dirichlet/diffuse/specular/periodic gate the merge off (the closures
    are implemented on the fine paths only)."""
    m = pmesh.make_cartesian_3d(2, 2, 2, "tet").scaled(1e-6)
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    bcs = {a: -0.5 for a in range(1, 6)}
    s = SourceIterationSolver(
        ops, quad, TABLES, bcs, dirichlet_bcs={6: 0.1},
        dtype=jnp.float64, supercell="on",
    )
    assert s._super is None


def test_gmsh_asset_supercell(reference_root):
    """The supercell merge must detect the structure of the reference's
    actual gmsh production meshes (generator: Reference Project/config/mesh/
    mesh_generator/cuboid_uniform_mesh.py), not just the builtins — the
    detection is connectivity-based, never element-order-based."""
    path = reference_root / "Reference Project/config/mesh/cuboid_2x2x2.msh"
    if not path.exists():
        pytest.skip("gmsh asset missing")
    m = pmesh.load_mesh(str(path)).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    s_sup = SourceIterationSolver(
        ops, quad, TABLES, bcs, dtype=jnp.float64,
        supercell="on", sweep_mode="ring",
    )
    assert s_sup._super is not None and s_sup.G == 8
    s_ref = SourceIterationSolver(
        ops, quad, TABLES, bcs, dtype=jnp.float64,
        supercell="off", sweep_mode="scan",
    )

    def run(s, n=3):
        u, Tc, Tv = s.initial_state()
        for _ in range(n):
            u, Tc, Tv, r = s.step(u, Tc, Tv)
        return Tc, float(r)

    Tc_s, r_s = run(s_sup)
    Tc_r, r_r = run(s_ref)
    scale = np.abs(np.asarray(Tc_r)).max()
    assert np.abs(s_sup.Tc_fine(Tc_s) - np.asarray(Tc_r)).max() < 1e-12 * scale
    assert abs(r_s - r_r) < 1e-12


def test_supercell_fold_ab_matches():
    """PBTE_SUPER_FOLD=1 (dense folded bcat) and the default two-matmul
    body must produce identical iterates."""
    import os as _os

    m = pmesh.make_cartesian_3d(2, 2, 2, "tet").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}

    def run(env):
        _os.environ.update(env)
        try:
            s = SourceIterationSolver(
                ops, quad, TABLES, bcs, dtype=jnp.float64,
                supercell="on", sweep_mode="ring",
            )
            assert s._super is not None
            u, Tc, Tv = s.initial_state()
            for _ in range(3):
                u, Tc, Tv, r = s.step(u, Tc, Tv)
            return np.asarray(Tc), float(r)
        finally:
            for k in env:
                _os.environ.pop(k, None)

    Tc_a, r_a = run({})
    Tc_b, r_b = run({"PBTE_SUPER_FOLD": "1"})
    scale = np.abs(Tc_a).max()
    assert np.abs(Tc_a - Tc_b).max() < 1e-12 * scale
    assert abs(r_a - r_b) < 1e-13


def test_supercell_wd_ab_matches():
    """The default W-minor layout and the opt-in WD layout
    (PBTE_SUPER_WD=1, D' minor) must produce identical iterates and
    outputs."""
    import os as _os

    m = pmesh.make_cartesian_3d(3, 2, 2, "tet").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}

    def run(env):
        _os.environ.update(env)
        try:
            s = SourceIterationSolver(
                ops, quad, TABLES, bcs, dtype=jnp.float64,
                supercell="on", sweep_mode="ring",
            )
            u, Tc, Tv = s.initial_state()
            for _ in range(3):
                u, Tc, Tv, r = s.step(u, Tc, Tv)
            return s, u, np.asarray(Tc), float(r)
        finally:
            for k in env:
                _os.environ.pop(k, None)

    s_wd, u_wd, Tc_a, r_a = run({"PBTE_SUPER_WD": "1"})
    s_wm, u_wm, Tc_b, r_b = run({})
    assert s_wd._ring_wd and not s_wm._ring_wd
    scale = np.abs(Tc_a).max()
    assert np.abs(Tc_a - Tc_b).max() < 1e-12 * scale
    assert abs(r_a - r_b) < 1e-13
    ud_a = s_wd.u_by_direction(u_wd)
    ud_b = s_wm.u_by_direction(u_wm)
    assert np.abs(ud_a - ud_b).max() < 1e-12 * max(np.abs(ud_b).max(), 1e-300)


def test_supercell_checkpoint_roundtrip(tmp_path):
    """Supercell ring state saves/loads (fingerprint tags the layout);
    resumed run == uninterrupted run."""
    from pbte.io.checkpoint import load_checkpoint, save_checkpoint

    m = pmesh.make_cartesian_3d(3, 2, 2, "tet").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    s = SourceIterationSolver(
        ops, quad, TABLES, bcs, dtype=jnp.float64,
        supercell="on", sweep_mode="ring",
    )
    assert s._super is not None
    full = s.solve(tol=0, max_iter=6, verbose=False)
    half = s.solve(tol=0, max_iter=3, verbose=False)
    ck = str(tmp_path / "super.npz")
    save_checkpoint(ck, s, half.u, half.Tc, half.Tv, 3, half.residual)
    state, it, _ = load_checkpoint(ck, s)
    assert it == 3
    resumed = s.solve(tol=0, max_iter=3, verbose=False, state=state)
    np.testing.assert_allclose(
        np.asarray(resumed.Tc), np.asarray(full.Tc), rtol=1e-12, atol=1e-18
    )
    # Tv is per FINE element in supercell mode
    assert np.asarray(full.Tv).shape == (s.ne_tv,)


@pytest.mark.slow
def test_auto_memory_policy_at_production_shape(monkeypatch):
    """The legacy FULL production config (5^3 6-tet, p=3, 16x24=384 dirs,
    2x20 bands) must build out of the box: supercell merge engaged, f32
    state where two f32 state buffers (4.9 GB) fit their share of a 16 GB
    budget, and the auto memory policy selecting bf16 state + donation
    where they do not (a 4 GB budget)."""
    from pbte import device

    m = pmesh.make_cartesian_3d(5, 5, 5, "tet").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=3,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=16, azimuth_points=24))
    tables = mat.build_tables(mat.SILICON, num_spectral=20)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    monkeypatch.setattr(device, "memory_budget", lambda: 16e9)
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float32)
    assert s._super is not None and s.sweep_mode == "ring"
    assert s.G == 8 and s.K == 384 and s.D == 120
    assert not s._ring_state_bf16 and not s._auto_mem
    del s
    monkeypatch.setattr(device, "memory_budget", lambda: 4e9)
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float32)
    assert s._super is not None and s.sweep_mode == "ring"
    assert s._ring_state_bf16 and s._auto_mem
    u, Tc, Tv = s.initial_state()
    assert u[0].dtype == jnp.bfloat16


# ---- box merge (detect_box): hex/quad lattices as block super elements ----


def test_detect_box_quad_and_rejections():
    m = pmesh.make_cartesian_2d(4, 4, "quad")
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    ops = assembly.permute_faces(ops, assembly.canonical_face_perm(ops))
    sc = supercell.detect_box(ops, 2)
    assert sc is not None
    assert sc.gsz == 4 and sc.ncell == 4
    assert sc.super_ops.ndof == 4 * ops.ndof
    assert sc.super_ops.faces_per_elem == 4
    assert sorted(sc.lat_dims) == [2, 2]
    assert np.array_equal(np.sort(sc.elem_at.reshape(-1)), np.arange(16))
    # each class has 2 intra face-sides in 2D factor 2
    assert len(sc.int_dst) == 4 * 2
    # odd extents are not divisible by the factor
    m3 = pmesh.make_cartesian_2d(5, 4, "quad")
    ops3 = assembly.assemble(
        pmesh.connect(m3), order=1, face_mode="consistent"
    )
    ops3 = assembly.permute_faces(ops3, assembly.canonical_face_perm(ops3))
    assert supercell.detect_box(ops3, 2) is None
    # simplex meshes have non-axis faces -> the box merge does not apply
    mt = pmesh.make_cartesian_2d(4, 4, "triangle")
    opst = assembly.assemble(
        pmesh.connect(mt), order=1, face_mode="consistent"
    )
    opst = assembly.permute_faces(opst, assembly.canonical_face_perm(opst))
    assert supercell.detect_box(opst, 2) is None


def test_box_quad_iterate_exact():
    m = pmesh.make_cartesian_2d(4, 4, "quad").scaled(1e-6)
    quad = ang.build(
        ang.AngularOptions(dimension=2, polar_points=1, azimuth_points=8)
    )
    bcs = {1: -0.5, 2: 0.0, 3: 0.5, 4: 0.0}
    s_ref, u_r, Tc_r, Tv_r, h_r = _run(
        m, quad, bcs, 1, sweep_mode="scan", supercell="off"
    )
    s_sup, u_s, Tc_s, Tv_s, h_s = _run(
        m, quad, bcs, 1, sweep_mode="ring", supercell_box=2
    )
    assert s_sup._super is not None and s_sup.sweep_mode == "ring"
    assert s_sup._super.gsz == 4 and s_sup.D == 4 * s_ref.D
    assert s_sup.G == 4
    np.testing.assert_allclose(h_s, h_r, rtol=1e-12)
    scale = np.abs(np.asarray(Tc_r)).max()
    assert (
        np.abs(s_sup.Tc_fine(Tc_s) - np.asarray(Tc_r)).max() < 1e-13 * scale
    )
    ud_r = s_ref.u_by_direction(u_r)
    ud_s = s_sup.u_by_direction(u_s)
    assert np.abs(ud_s - ud_r).max() < 1e-13 * np.abs(ud_r).max()


def test_box_quad_factor3_iterate_exact():
    """factor 3 (gsz=9): a deeper intra-block DAG than any simplex split —
    exercises the block forward substitution beyond 2 sub-diagonal deps."""
    m = pmesh.make_cartesian_2d(6, 3, "quad").scaled(1e-6)
    quad = ang.build(
        ang.AngularOptions(dimension=2, polar_points=1, azimuth_points=4)
    )
    bcs = {1: -0.5, 2: 0.0, 3: 0.5, 4: 0.0}
    s_ref, u_r, Tc_r, Tv_r, h_r = _run(
        m, quad, bcs, 1, sweep_mode="scan", supercell="off"
    )
    s_sup, u_s, Tc_s, Tv_s, h_s = _run(
        m, quad, bcs, 1, sweep_mode="ring", supercell_box=3
    )
    assert s_sup._super is not None and s_sup._super.gsz == 9
    assert sorted(s_sup._super.lat_dims) == [1, 2]
    np.testing.assert_allclose(h_s, h_r, rtol=1e-12)
    scale = np.abs(np.asarray(Tc_r)).max()
    assert (
        np.abs(s_sup.Tc_fine(Tc_s) - np.asarray(Tc_r)).max() < 1e-13 * scale
    )


@pytest.mark.parametrize("order", [1, 2])
def test_box_hex_iterate_exact(order):
    m = pmesh.make_cartesian_3d(4, 4, 2, "hex").scaled(1e-6)
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
    )
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    s_ref, u_r, Tc_r, Tv_r, h_r = _run(
        m, quad, bcs, order, sweep_mode="scan", supercell="off"
    )
    s_sup, u_s, Tc_s, Tv_s, h_s = _run(
        m, quad, bcs, order, sweep_mode="ring", supercell_box=2
    )
    assert s_sup._super is not None and s_sup.sweep_mode == "ring"
    assert s_sup._super.gsz == 8 and s_sup.D == 8 * s_ref.D
    # super lattice 2x2x1: z-sign groups collapse into G=4 distinct orders
    np.testing.assert_allclose(h_s, h_r, rtol=1e-11)
    scale = np.abs(np.asarray(Tc_r)).max()
    assert (
        np.abs(s_sup.Tc_fine(Tc_s) - np.asarray(Tc_r)).max() < 1e-12 * scale
    )
    ud_r = s_ref.u_by_direction(u_r)
    ud_s = s_sup.u_by_direction(u_s)
    assert np.abs(ud_s - ud_r).max() < 1e-12 * np.abs(ud_r).max()
    Qc_r, Qv_r = s_ref.heat_flux(u_r)
    Qc_s, Qv_s = s_sup.heat_flux(u_s)
    qs = np.abs(np.asarray(Qv_r)).max()
    assert np.abs(np.asarray(Qv_s) - np.asarray(Qv_r)).max() < 1e-12 * qs
    assert (
        np.abs(np.asarray(Qc_s) - np.asarray(Qc_r)).max()
        < 1e-12 * np.abs(np.asarray(Qc_r)).max()
    )
