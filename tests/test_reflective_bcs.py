"""Diffuse (legacy type 2) and specular (type 3) boundary conditions.

BOTH reference trees parse these types and reject them at solve time
(ref: Reference Project/config/control/Control.yaml:23-30,
Reference Project/src/DGSolver/PBTE_NonGraySMRT.cpp:125-127) — this
framework implements them as LAGGED closures (previous outer iterate),
exactly like periodic wraps:

- diffuse: face-isotropic incoming intensity per band, sized so the face's
  net UPWIND energy flux per band is zero (Lambert reflection),
- specular: the element's own lagged trace at the mirrored direction
  s' = s - 2(s.n)n, which must land exactly on another quadrature node.

Validation strategy (no reference implementation exists to diff against):
(a) the batched solver must match the sequential numpy oracle element-wise,
(b) physics invariants at convergence — exact per-face zero net upwind flux
through diffuse walls, global energy balance under the conserved current
weights w_k*domega_b*v_g_b, and mirror symmetry of the field under
specular walls on a symmetric problem.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.solver.source_iteration import SourceIterationSolver
from pbte.validation.oracle import mirror_direction_map, solve_oracle


def _problem2d(nx=4, ny=3, nspec=2, ndir=8):
    m = pmesh.make_cartesian_2d(nx, ny, "quad").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=ndir))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def test_mirror_map_symmetry_detection():
    """The gauss azimuth rule on [0,2pi] is mirror-symmetric about y but
    NOT about x; the uniform rule with a multiple-of-4 count is symmetric
    about both. The map must detect this and the matched weights must be
    identical."""
    g = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    mm = mirror_direction_map(g, 2, axes=[1])
    d = g.directions[:, :2]
    np.testing.assert_allclose(d[mm[1]][:, 0], d[:, 0], atol=1e-12)
    np.testing.assert_allclose(d[mm[1]][:, 1], -d[:, 1], atol=1e-12)
    with pytest.raises(ValueError, match="not mirror-symmetric"):
        mirror_direction_map(g, 2, axes=[0])
    u = ang.build(ang.AngularOptions(
        dimension=2, azimuth_points=8, azimuth_scheme="uniform"))
    mm = mirror_direction_map(u, 2)  # both axes fine
    assert (mm >= 0).all()


def test_diffuse_solver_matches_oracle():
    ops, quad, tables = _problem2d()
    bcs = {2: 0.5, 4: -0.5}
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=6,
                               diffuse=[1, 3])
    s = SourceIterationSolver(ops, quad, tables, bcs, diffuse_bcs=[1, 3])
    r = s.solve(tol=0, max_iter=6, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_specular_solver_matches_oracle():
    ops, quad, tables = _problem2d()
    bcs = {2: 0.5, 4: -0.5}
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=6,
                               specular=[1, 3])
    s = SourceIterationSolver(ops, quad, tables, bcs, specular_bcs=[1, 3])
    r = s.solve(tol=0, max_iter=6, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_mixed_reflective_dirichlet_matches_oracle():
    """Diffuse bottom + specular top + Dirichlet right + isothermal left,
    all in one problem (every lagged source coexists in the rhs base)."""
    ops, quad, tables = _problem2d()
    uo, Tco, *_ = solve_oracle(ops, quad, tables, {4: -0.5}, tol=0,
                               max_iter=6, diffuse=[1], specular=[3],
                               dirichlet={2: 0.25})
    s = SourceIterationSolver(ops, quad, tables, {4: -0.5},
                              diffuse_bcs=[1], specular_bcs=[3],
                              dirichlet_bcs={2: 0.25})
    r = s.solve(tol=0, max_iter=6, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_diffuse_3d_hex_matches_oracle():
    m = pmesh.make_cartesian_3d(3, 3, 3, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {5: -0.5, 3: 0.5}  # x faces isothermal; the other four diffuse
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5,
                               diffuse=[1, 2, 4, 6])
    s = SourceIterationSolver(ops, quad, tables, bcs,
                              diffuse_bcs=[1, 2, 4, 6])
    assert s.sweep_mode == "scan"
    r = s.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_diffuse_energy_conservation_at_convergence():
    """Converged field: every diffuse wall carries exactly zero net UPWIND
    energy flux per band (the closure's defining property), and the global
    boundary balance closes under the conserved-current weights
    w_k * domega_b * v_g_b (the discrete BGK system's energy functional —
    with the Tc closure the volumetric scattering term vanishes under
    exactly these weights)."""
    m = pmesh.make_cartesian_2d(3, 3, "quad").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=1)
    bcs = {2: 0.5, 4: -0.5}
    s = SourceIterationSolver(ops, quad, tables, bcs, diffuse_bcs=[1, 3])
    r = s.solve(tol=1e-14, max_iter=3000, verbose=False, check_every=20)
    u = s.u_by_direction(r.u)  # (K, BS, ne, D)

    dirs = quad.directions[:, :2]
    w = quad.weights
    vg = tables.flat("vg")
    hc = tables.flat("heat_cap")
    dw = tables.flat("dw")
    om = quad.total_weight
    mb = dw * vg
    fdot = np.einsum("efd,kd->kef", ops.normals, dirs)

    def upwind_flux(e, f):
        intF_u = np.einsum("kbi,i->kb", u[:, :, e], ops.face_int[e, f])
        areaF = ops.face_int[e, f].sum()
        fp = np.maximum(fdot[:, e, f], 0.0)
        fm = np.minimum(fdot[:, e, f], 0.0)
        out = np.einsum("k,b,kb->", w, mb, fp[:, None] * intF_u)
        attr = int(ops.face_attr[e, f])
        if attr in bcs:
            uin = hc / om * bcs[attr]
        else:  # the diffuse closure's isotropic intensity
            uin = np.einsum("k,kb->b", w * fp, intF_u) / (
                (w * (-fm)).sum() * areaF
            )
        return out + np.einsum("k,b,b->", w * fm, mb, uin) * areaF

    fluxes = {}
    for e, f in np.argwhere(ops.neighbor < 0):
        a = int(ops.face_attr[e, f])
        fluxes[a] = fluxes.get(a, 0.0) + upwind_flux(e, f)
    gross = sum(abs(v) for v in fluxes.values())
    assert abs(fluxes[1]) / gross < 1e-12  # diffuse walls: exactly balanced
    assert abs(fluxes[3]) / gross < 1e-12
    assert abs(sum(fluxes.values())) / gross < 1e-10  # global balance


def test_specular_mirror_symmetry():
    """Specular side walls on a y-symmetric problem: the converged field
    must be exactly y-mirror-symmetric (specular walls are 'free-slip')."""
    m = pmesh.make_cartesian_2d(4, 4, "quad").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=1)
    s = SourceIterationSolver(ops, quad, tables, {2: 0.5, 4: -0.5},
                              specular_bcs=[1, 3])
    r = s.solve(tol=1e-13, max_iter=3000, verbose=False, check_every=20)
    Tv = np.asarray(r.Tv).reshape(4, 4)  # rows = y
    sym = np.abs(Tv - Tv[::-1]).max() / np.abs(Tv).max()
    assert sym < 1e-9


def _hex8():
    m = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    return ops, quad, tables


def test_diffuse_ring_lattice_matches_oracle():
    """Reflective closures on the shift-structured LATTICE ring (the
    production sweep): contributions gather from the slab state through
    M^-T-folded vectors and scatter into rhs_extra — iterate-exact vs the
    sequential oracle. ne=512 triggers canonical faces + lattice tables."""
    ops, quad, tables = _hex8()
    bcs = {5: -0.5, 3: 0.5}
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5,
                               diffuse=[1, 2, 4, 6])
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                              diffuse_bcs=[1, 2, 4, 6], sweep_mode="ring")
    assert s.sweep_mode == "ring" and s._ring_lattice
    r = s.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_specular_ring_lattice_matches_oracle():
    ops, quad, tables = _hex8()
    bcs = {5: -0.5, 3: 0.5}
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5,
                               specular=[1, 2, 4, 6])
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                              specular_bcs=[1, 2, 4, 6], sweep_mode="ring")
    assert s.sweep_mode == "ring" and s._ring_lattice
    r = s.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_mixed_reflective_ring_one_hot_matches_oracle():
    """All lagged sources together (diffuse + specular + Dirichlet) on the
    general one-hot ring (ne < 512 keeps the pre-canonical face order, so
    lattice detection fails and the one-hot selection path runs)."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {5: -0.5}
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5,
                               diffuse=[1, 4], specular=[2, 6],
                               dirichlet={3: 0.25})
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                              diffuse_bcs=[1, 4], specular_bcs=[2, 6],
                              dirichlet_bcs={3: 0.25}, sweep_mode="ring")
    assert s.sweep_mode == "ring" and not s._ring_lattice
    r = s.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-10, atol=1e-14)


def test_diffuse_ring_dir_sharded_matches_oracle():
    """The diffuse hemisphere flux sums outgoing directions across dir
    shards (XLA inserts the all-reduce under NamedSharding); the mirror
    gather crosses shards likewise."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:4])
    sharding = NamedSharding(Mesh(devs, axis_names=("dir",)), P("dir"))
    ops, quad, tables = _problem2d(nx=6, ny=6)
    bcs = {2: 0.5, 4: -0.5}
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5,
                               diffuse=[1], specular=[3])
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                              diffuse_bcs=[1], specular_bcs=[3],
                              sweep_mode="ring", dir_sharding=sharding)
    assert s.sweep_mode == "ring"
    r = s.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-10, atol=1e-14)


def test_config_parses_reflective_types(tmp_path):
    """Legacy Control.yaml types 2/3 and modern 'diffuse'/'specular'
    entries land in RunConfig (the reference parses these types too but
    its solvers reject them)."""
    from pbte.config import load_legacy_control, load_run_config

    ctrl = tmp_path / "Control.yaml"
    ctrl.write_text(
        "SPATIAL_DIM: 2\nPOLYDEG: 1\nNAZIM: 8\nNSPEC: 2\n"
        "BOUNDARY_COND:\n  1: [2, 0.0]\n  2: [1, 0.5]\n  3: [3, 0.0]\n"
        "  4: [1, -0.5]\n"
    )
    rc = load_legacy_control(str(ctrl))
    assert rc.diffuse_attrs == [1] and rc.specular_attrs == [3]
    assert rc.bc_temps == {2: 0.5, 4: -0.5}

    cfg = tmp_path / "config.yaml"
    cfg.write_text(
        "boundary_conditions:\n"
        "  - {attr: 1, type: diffuse}\n"
        "  - {attr: 2, temperature: 0.5}\n"
        "  - {attr: 3, type: specular}\n"
        "  - {attr: 4, temperature: -0.5}\n"
    )
    rc2 = load_run_config(str(cfg))
    assert rc2.diffuse_attrs == [1] and rc2.specular_attrs == [3]


def test_reflective_on_mixed_geometry_mesh():
    """Composition: diffuse + specular walls on the 4-geometry mixed cube
    (hex + pyramids + tets + prisms) — padded face slots and the per-
    geometry padded DOFs flow through the lagged closures unchanged."""
    m = pmesh.load_builtin("unit-cube-mixed").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {5: -0.5, 3: 0.5}
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5,
                               diffuse=[1, 6], specular=[2, 4])
    s = SourceIterationSolver(ops, quad, tables, bcs, diffuse_bcs=[1, 6],
                              specular_bcs=[2, 4])
    r = s.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11,
                               atol=1e-14)


def test_diffuse_with_periodic_ring_shares_rhs_extra():
    """Periodic wraps and reflective closures both scatter into the ring's
    rhs_extra — they must accumulate, not clobber."""
    m = pmesh.make_cartesian_2d(8, 8, "quad").scaled(1e-6)
    m = pmesh.make_periodic(m, [0])
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    attrs = sorted(int(a) for a in np.unique(ops.face_attr[ops.neighbor < 0]))
    bcs = {attrs[0]: 0.5}
    dif = [a for a in attrs[1:]]
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=6,
                               diffuse=dif)
    s = SourceIterationSolver(ops, quad, tables, bcs, diffuse_bcs=dif,
                              sweep_mode="ring", dtype=jnp.float64)
    assert s.sweep_mode == "ring" and s.has_periodic
    r = s.solve(tol=0, max_iter=6, verbose=False)
    np.testing.assert_allclose(np.asarray(r.Tc), Tco, rtol=1e-11, atol=1e-14)
