"""SlabLatticeSolver: flagship-capable domain decomposition on lattice
meshes — slab partitions along a major axis, per-device lattice ring sweep,
lagged ppermute halo (block-Jacobi), ("dir", "space") device mesh.

Ground truth: the sequential lagged-interface oracle (validation.oracle,
part=slab partition) reproduces the legacy MPI semantics iterate-exactly
(ref: reference/DGSolver/PBTE_NonGraySMRT_MPI.cpp:403-506)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.parallel.slab import SlabLatticeSolver
from pbte.solver.source_iteration import SourceIterationSolver
from pbte.validation.oracle import solve_oracle

BCS3 = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}
BCS2 = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}


def _mesh2x4():
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    return Mesh(devs, axis_names=("dir", "space"))


def _slab_part(s, ne):
    part = np.zeros(ne, dtype=np.int64)
    for p in range(s.P):
        es = s.elems_p[p]
        part[es[es >= 0]] = p
    return part


def test_slab_matches_lagged_oracle_3d():
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    s = SlabLatticeSolver(ops, quad, tables, BCS3, device_mesh=_mesh2x4(),
                          dtype=jnp.float64)
    assert s.P == 4 and s.shift_vals == (0, 4, 1)
    res = s.solve(tol=0, max_iter=4, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, BCS3, tol=0, max_iter=4,
                               part=_slab_part(s, ops.num_elements))
    np.testing.assert_allclose(res.Tc_global(), Tco, rtol=1e-12,
                               atol=1e-13 * np.abs(Tco).max())


def test_slab_periodic_dirichlet_oracle():
    """Plane-axis periodic wrap + Dirichlet faces, both lagged couplings."""
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    m = pmesh.make_periodic(m, [1])
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    attrs = sorted(int(a) for a in np.unique(ops.face_attr[ops.neighbor < 0]))
    top = max(attrs)
    bcs = {a: -0.5 for a in attrs if a != top}
    s = SlabLatticeSolver(ops, quad, tables, bcs, device_mesh=_mesh2x4(),
                          dtype=jnp.float64, dirichlet_bcs={top: 0.25})
    assert s.has_periodic and s.has_dirichlet and s.a0 == 0
    res = s.solve(tol=0, max_iter=5, verbose=False)
    uo, Tco, *_ = solve_oracle(
        ops, quad, tables, bcs, tol=0, max_iter=5,
        part=_slab_part(s, ops.num_elements), dirichlet={top: 0.25},
    )
    np.testing.assert_allclose(res.Tc_global(), Tco, rtol=1e-12,
                               atol=1e-13 * np.abs(Tco).max())


def test_slab_2d_quad_oracle():
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    m = pmesh.make_cartesian_2d(8, 6, "quad").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=2, face_mode="consistent")
    s = SlabLatticeSolver(ops, quad, tables, BCS2, device_mesh=_mesh2x4(),
                          dtype=jnp.float64)
    res = s.solve(tol=0, max_iter=5, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, BCS2, tol=0, max_iter=5,
                               part=_slab_part(s, ops.num_elements))
    np.testing.assert_allclose(res.Tc_global(), Tco, rtol=1e-12,
                               atol=1e-13 * np.abs(Tco).max())


def test_slab_converges_to_single_device_fixed_point():
    """Block-Jacobi (slab) and Gauss-Seidel (single-device) share the fixed
    point; converged fields must agree to the convergence tolerance."""
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    s = SlabLatticeSolver(ops, quad, tables, BCS3, device_mesh=_mesh2x4(),
                          dtype=jnp.float64)
    r = s.solve(tol=1e-12, max_iter=2000, verbose=False, check_every=100)
    sd = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64)
    rd = sd.solve(tol=1e-12, max_iter=2000, verbose=False, check_every=100)
    Tc_ref = np.asarray(rd.Tc)
    np.testing.assert_allclose(
        r.Tc_global(), Tc_ref, rtol=0, atol=1e-9 * np.abs(Tc_ref).max()
    )
    # state views on the distributed layout
    ud = s.u_by_direction(r.u)
    assert ud.shape == (s.K, s.BS, s.ne, s.D) and np.isfinite(ud).all()
    Qc, Qv = s.heat_flux(r.u)
    assert np.asarray(Qv).sum(axis=1)[2] < 0  # heat flows down from hot top


def test_slab_checkpoint_roundtrip(tmp_path):
    from pbte.io.checkpoint import load_checkpoint, save_checkpoint

    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    s = SlabLatticeSolver(ops, quad, tables, BCS3, device_mesh=_mesh2x4(),
                          dtype=jnp.float64)
    full = s.solve(tol=0, max_iter=6, verbose=False)
    half = s.solve(tol=0, max_iter=3, verbose=False)
    ck = str(tmp_path / "slab.npz")
    save_checkpoint(ck, s, half.u, half.Tc, half.Tv, 3, half.residual)
    state, it, _ = load_checkpoint(ck, s)
    assert it == 3
    resumed = s.solve(tol=0, max_iter=3, verbose=False, state=state)
    np.testing.assert_allclose(
        resumed.Tc_global(), full.Tc_global(), rtol=1e-12, atol=1e-15
    )


def test_slab_bicgstab_accelerated():
    """Krylov acceleration over the slab-partitioned state: the lagged
    ppermute halo is linear in the previous iterate, so BiCGStab converges
    to the same block-Jacobi fixed point in far fewer step applications."""
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    s = SlabLatticeSolver(ops, quad, tables, BCS3, device_mesh=_mesh2x4(),
                          dtype=jnp.float64)
    r_plain = s.solve(tol=1e-10, max_iter=2000, verbose=False,
                      check_every=20)
    r_acc = s.solve(tol=1e-10, max_iter=2000, verbose=False, check_every=20,
                    accelerate="bicgstab")
    assert r_acc.iterations * 3 < r_plain.iterations, (
        r_acc.iterations, r_plain.iterations)
    Tp, Ta = r_plain.Tc_global(), r_acc.Tc_global()
    np.testing.assert_allclose(Ta, Tp, rtol=0, atol=1e-7 * np.abs(Tp).max())


def test_slab_reflective_matches_lagged_oracle():
    """Diffuse + specular on the slab solver: partition-local face tables,
    diffuse flux psum'd over "dir", specular mirror via an all_gather'd
    boundary block — iterate-exact vs the lagged-interface oracle."""
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    # x walls (attrs 5/3) isothermal — the gauss azimuth rule is not
    # mirror-symmetric about x, so specular goes on the y/z walls
    bcs = {5: -0.5, 3: 0.5}
    dif, spc = [1, 2], [4, 6]
    s = SlabLatticeSolver(ops, quad, tables, bcs, device_mesh=_mesh2x4(),
                          dtype=jnp.float64, diffuse_bcs=dif,
                          specular_bcs=spc)
    assert s._dif_on and s._spc_on
    res = s.solve(tol=0, max_iter=5, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5,
                               part=_slab_part(s, ops.num_elements),
                               diffuse=dif, specular=spc)
    np.testing.assert_allclose(res.Tc_global(), Tco, rtol=1e-11,
                               atol=1e-13 * np.abs(Tco).max())


def test_slab_reflective_converges_to_single_device():
    """Reflective slab fixed point == single-device fixed point (lagging
    vanishes at convergence)."""
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    attrs = sorted(int(a) for a in np.unique(ops.face_attr[ops.neighbor < 0]))
    bcs = {attrs[0]: -0.5, attrs[-1]: 0.5}
    dif = [a for a in attrs if a not in bcs]
    s = SlabLatticeSolver(ops, quad, tables, bcs, device_mesh=_mesh2x4(),
                          dtype=jnp.float64, diffuse_bcs=dif)
    r = s.solve(tol=1e-12, max_iter=1500, verbose=False, check_every=100)
    sd = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                               diffuse_bcs=dif)
    rd = sd.solve(tol=1e-12, max_iter=1500, verbose=False, check_every=100)
    Tc_ref = np.asarray(rd.Tc)
    np.testing.assert_allclose(
        r.Tc_global(), Tc_ref, rtol=0, atol=1e-9 * np.abs(Tc_ref).max()
    )


def test_slab_reflective_attr_without_faces_is_inert():
    """A diffuse/specular attr matching no boundary face must disable the
    closure (SourceIterationSolver semantics), not crash table building."""
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    m = pmesh.make_cartesian_3d(6, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    s = SlabLatticeSolver(ops, quad, tables, BCS3, device_mesh=_mesh2x4(),
                          dtype=jnp.float64, diffuse_bcs=[99],
                          specular_bcs=[98], require_bcs=False)
    assert not s._dif_on and not s._spc_on and s._refl_tabs is None
    res = s.solve(tol=0, max_iter=3, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, BCS3, tol=0, max_iter=3,
                               part=_slab_part(s, ops.num_elements))
    np.testing.assert_allclose(res.Tc_global(), Tco, rtol=1e-12,
                               atol=1e-13 * np.abs(Tco).max())
