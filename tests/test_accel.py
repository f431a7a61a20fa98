"""Krylov-accelerated source iteration (solver/accel.py, accelerate="bicgstab").

The outer iteration is affine, so BiCGStab on (I - A) x = b — one plain
step per matvec — reaches the SAME fixed point in far fewer step
applications. These tests pin: (a) the fixed point is unchanged, (b) the
acceleration is real (>= 3x fewer steps; measured ~6x), (c) it composes
with the scan path, Dirichlet + reflective closures, and warm starts."""

import numpy as np

import jax.numpy as jnp

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.solver.source_iteration import SourceIterationSolver

BCS3 = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}


def _problem(nx=8, geom="hex", order=1, nspec=2):
    m = pmesh.make_cartesian_3d(nx, nx, nx, geom).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def test_bicgstab_matches_plain_fixed_point_ring():
    ops, quad, tables = _problem()
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    r_plain = s.solve(tol=1e-10, max_iter=3000, verbose=False,
                      check_every=10)
    r_acc = s.solve(tol=1e-10, max_iter=3000, verbose=False, check_every=10,
                    accelerate="bicgstab")
    assert r_plain.residual < 1e-10 and r_acc.residual < 1e-9
    # measured 192 vs 1130 step applications; require the 3x floor
    assert r_acc.iterations * 3 < r_plain.iterations, (
        r_acc.iterations, r_plain.iterations)
    Tp, Ta = np.asarray(r_plain.Tc), np.asarray(r_acc.Tc)
    np.testing.assert_allclose(Ta, Tp, rtol=0, atol=1e-7 * np.abs(Tp).max())


def test_bicgstab_scan_path_with_dirichlet_and_diffuse():
    """The affine-map assumption must hold end-to-end for every boundary
    closure: Dirichlet source (constant) and diffuse reflection (linear in
    the previous iterate) on the compact scan path."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    kw = dict(dtype=jnp.float64, sweep_mode="scan",
              dirichlet_bcs={6: 0.25}, diffuse_bcs=[1])
    bcs = {a: -0.5 for a in (2, 3, 4, 5)}
    s = SourceIterationSolver(ops, quad, tables, bcs, **kw)
    r_plain = s.solve(tol=1e-11, max_iter=4000, verbose=False,
                      check_every=10)
    r_acc = s.solve(tol=1e-11, max_iter=4000, verbose=False, check_every=10,
                    accelerate="bicgstab")
    assert r_acc.iterations * 3 < r_plain.iterations
    Tp, Ta = np.asarray(r_plain.Tc), np.asarray(r_acc.Tc)
    np.testing.assert_allclose(Ta, Tp, rtol=0, atol=1e-7 * np.abs(Tp).max())


def test_bicgstab_warm_start():
    """A warm start (plain half-solve, or a checkpoint) seeds r0 = F(x)-x."""
    ops, quad, tables = _problem(nx=4)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64)
    half = s.solve(tol=0, max_iter=50, verbose=False, check_every=10)
    cold = s.solve(tol=1e-10, max_iter=3000, verbose=False, check_every=10,
                   accelerate="bicgstab")
    warm = s.solve(tol=1e-10, max_iter=3000, verbose=False, check_every=10,
                   accelerate="bicgstab",
                   state=(half.u, half.Tc, half.Tv))
    Tc_c, Tc_w = np.asarray(cold.Tc), np.asarray(warm.Tc)
    np.testing.assert_allclose(
        Tc_w, Tc_c, rtol=0, atol=1e-7 * np.abs(Tc_c).max()
    )


def test_bicgstab_with_dir_sharding():
    """The Krylov tree kernels must compose with NamedSharding state (the
    stage jits carry no annotations; GSPMD propagates the leaf shardings)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    ops, quad, tables = _problem(nx=4)
    devs = np.array(jax.devices()[:2])
    sharding = NamedSharding(Mesh(devs, axis_names=("dir",)), P("dir"))
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              dir_sharding=sharding)
    s0 = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64)
    r = s.solve(tol=1e-10, max_iter=2000, verbose=False, check_every=10,
                accelerate="bicgstab")
    r0 = s0.solve(tol=1e-10, max_iter=2000, verbose=False, check_every=10,
                  accelerate="bicgstab")
    T, T0 = np.asarray(r.Tc), np.asarray(r0.Tc)
    np.testing.assert_allclose(T, T0, rtol=0, atol=1e-8 * np.abs(T0).max())


def test_bicgstab_stagnation_guard_is_cadence_independent(reference_root):
    """Regression: at check_every=1 the stagnation guard's window used to be
    6 fetches = 12 matvecs — BiCGStab on the nonnormal sweep operator
    routinely plateaus that long MID-solve, so the 2D reference-config
    problem stopped at relres 1.6e-5 on its way to 3.6e-10 (measured). The
    guard now additionally requires >=60 matvecs without a 10% improvement,
    making the stop cadence-independent; this run must reach the tolerance."""
    from pbte import mesh as pmesh2

    m = pmesh2.load_mfem_mesh(
        str(reference_root / "config/mesh/unit-square-iso.mesh"))
    ops = assembly.assemble(pmesh2.connect(m.scaled(1.0e-6)), order=1,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=24))
    tables = mat.build_tables(mat.SILICON, num_spectral=20)
    s = SourceIterationSolver(ops, quad, tables, {1: -0.5, 2: 0.5},
                              dtype=jnp.float64)
    r = s.solve(tol=1e-9, max_iter=3000, verbose=False, check_every=1,
                accelerate="bicgstab")
    assert r.residual < 1e-9, r.residual


def test_bicgstab_checkpoint_and_max_iter_cap(tmp_path):
    """Accelerated solves must honor checkpoint_path/checkpoint_every (the
    accel branch used to silently drop them) and keep `iterations` within
    max_iter (the trailing Tv-recovery steps are reserved in the loop
    guard). The checkpoint must warm-start a resumed accelerated solve to
    the same fixed point."""
    ops, quad, tables = _problem(nx=4)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64)
    ck = str(tmp_path / "accel_ck.npz")
    r1 = s.solve(tol=1e-30, max_iter=40, verbose=False, check_every=2,
                 accelerate="bicgstab", checkpoint_path=ck,
                 checkpoint_every=5)
    assert r1.iterations <= 40, r1.iterations
    import os

    assert os.path.exists(ck), "accelerated solve wrote no checkpoint"
    from pbte.io.checkpoint import load_checkpoint

    state, nmv_ck, _ = load_checkpoint(ck, s)
    assert nmv_ck > 0
    ref = s.solve(tol=1e-10, max_iter=3000, verbose=False, check_every=10,
                  accelerate="bicgstab")
    resumed = s.solve(tol=1e-10, max_iter=3000, verbose=False,
                      check_every=10, accelerate="bicgstab", state=state)
    Tr, Tc = np.asarray(ref.Tc), np.asarray(resumed.Tc)
    np.testing.assert_allclose(Tc, Tr, rtol=0, atol=1e-7 * np.abs(Tr).max())


def test_bicgstab_ring_path_with_reflective():
    """Same affine-map check on the RING path with reflective closures
    (the contributions scatter through rhs_extra; still linear in the
    previous iterate, so the Krylov outer loop applies unchanged)."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    kw = dict(dtype=jnp.float64, sweep_mode="ring",
              diffuse_bcs=[1], specular_bcs=[4, 6])
    bcs = {a: -0.5 for a in (2, 3)} | {5: 0.5}
    s = SourceIterationSolver(ops, quad, tables, bcs, **kw)
    assert s.sweep_mode == "ring"
    r_plain = s.solve(tol=1e-11, max_iter=4000, verbose=False,
                      check_every=10)
    r_acc = s.solve(tol=1e-11, max_iter=4000, verbose=False, check_every=10,
                    accelerate="bicgstab")
    assert r_acc.iterations * 3 < r_plain.iterations
    Tp, Ta = np.asarray(r_plain.Tc), np.asarray(r_acc.Tc)
    np.testing.assert_allclose(Ta, Tp, rtol=0, atol=1e-7 * np.abs(Tp).max())


def test_compensated_matches_plain_fixed_point_f64():
    """accelerate='compensated' (double-f32 TwoSum state, accel.py) in f64:
    the error part stays ~2^-52 and the converged field must equal the
    plain fixed point; 2 step applications per outer iteration."""
    ops, quad, tables = _problem(nx=4)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring", supercell="off")
    r_plain = s.solve(tol=1e-11, max_iter=2000, verbose=False,
                      check_every=10)
    r_comp = s.solve(tol=1e-11, max_iter=2000, verbose=False,
                     check_every=10, accelerate="compensated")
    assert r_comp.residual < 1e-10
    Tp, Tc_ = np.asarray(r_plain.Tc), np.asarray(r_comp.Tc)
    np.testing.assert_allclose(Tc_, Tp, rtol=0, atol=1e-9 * np.abs(Tp).max())


def test_compensated_f32_floor_equals_plain_floor():
    """MEASURED REFUTATION: in float32 with exact CPU
    dots, the compensated double-f32 state converges to the IDENTICAL
    floor as the plain iteration (1.83e-6 rel-L2 vs f64 truth at hex 6^3)
    — the converged bias is the f32 rounding of the step's own OUTPUTS,
    not state-storage rounding. Pinned here so the refutation stays
    reproducible; the output-rounding fix is refined_solve (see
    test_refined_solve_reaches_1e8)."""
    ops, quad, tables = _problem(nx=6)
    s64 = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                                sweep_mode="ring", supercell="off")
    truth = np.asarray(
        s64.solve(tol=1e-12, max_iter=4000, verbose=False,
                  check_every=20).Tc
    )
    s32 = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float32,
                                sweep_mode="ring", supercell="off")
    r_plain = s32.solve(tol=0, max_iter=3000, verbose=False, check_every=100)
    r_comp = s32.solve(tol=0, max_iter=3000, verbose=False, check_every=100,
                       accelerate="compensated")
    scale = np.linalg.norm(truth)
    b_plain = np.linalg.norm(np.asarray(r_plain.Tc, dtype=np.float64)
                             - truth) / scale
    b_comp = np.linalg.norm(np.asarray(r_comp.Tc, dtype=np.float64)
                            - truth) / scale
    assert b_plain < 5e-6 and b_comp < 5e-6, (b_comp, b_plain)
    # the refutation: no improvement beyond 20% either way
    assert abs(b_comp - b_plain) < 0.2 * b_plain, (b_comp, b_plain)


def test_refined_solve_reaches_1e8():
    """Iterative refinement (accel.refined_solve): f32 base solve + ONE
    f64 defect step + f32 correction solve must land within 1e-8 rel-L2 of
    the f64 truth — the field-precision north star (ROADMAP.md), met
    with float64 used only for a single step application."""
    from pbte.solver import accel

    ops, quad, tables = _problem(nx=6)
    s64 = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                                sweep_mode="ring", supercell="off")
    truth = np.asarray(
        s64.solve(tol=1e-12, max_iter=4000, verbose=False,
                  check_every=20).Tc
    )
    s32 = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float32,
                                sweep_mode="ring", supercell="off")
    out = accel.refined_solve(
        s32, s64.step, tol=1e-9, max_iter=4000,
        inner_tol=1e-5, inner_max_iter=2000,
        verbose=False, check_every=50,
    )
    bias = (np.linalg.norm(out["Tc_refined"] - truth)
            / np.linalg.norm(truth))
    base_bias = (np.linalg.norm(
        np.asarray(out["base_result"].Tc, np.float64) - truth)
        / np.linalg.norm(truth))
    # base floors ~1.8e-6; refinement must cross the north-star line
    assert base_bias > 1e-7, base_bias
    assert bias < 1e-8, (bias, base_bias, out["defect_norm"],
                         out["correction_relres"])


def test_correction_bicgstab_matches_plain_correction():
    """correction_bicgstab solves the SAME (I - A) e = d system as
    correction_outer (Krylov vs plain fixed point): identical solution
    tree, >= 3x fewer step applications (measured ~6x). This is the
    inner solver of the refined flagship runner's --inner krylov mode."""
    import jax

    from pbte.solver import accel

    ops, quad, tables = _problem(nx=4)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring", supercell="off")

    def step_fn(u, Tc, Tv):
        return s._step_plain(s.consts, u, Tc, Tv)

    # a deterministic state-shaped defect: d = 1e-3 * F(0)
    u0, Tc0, Tv0 = s.initial_state()
    uF, TcF, _, _ = step_fn(u0, Tc0, Tv0)
    d = jax.tree_util.tree_map(lambda a: 1e-3 * a, (uF, TcF))

    e_plain, n_plain, rel_plain = accel.correction_outer(
        step_fn, s.initial_state(), d, tol=1e-10, max_iter=3000,
        verbose=False, check_every=10)
    e_kry, n_kry, rel_kry = accel.correction_bicgstab(
        step_fn, s.initial_state(), d, tol=1e-10, max_iter=3000,
        verbose=False, check_every=5)
    # host-spilled-d variant (the flagship memory envelope): d's device
    # buffers are deleted, the recurrence must be unaffected
    d2 = jax.tree_util.tree_map(lambda a: a.copy(), d)
    e_sp, n_sp, rel_sp = accel.correction_bicgstab(
        step_fn, s.initial_state(), d2, tol=1e-10, max_iter=3000,
        verbose=False, check_every=5, consume_d=True)
    assert all(l.is_deleted() for l in jax.tree_util.tree_leaves(d2))
    assert n_sp == n_kry and rel_sp < 1e-10, (n_sp, n_kry, rel_sp)
    assert rel_plain < 1e-10 and rel_kry < 1e-10, (rel_plain, rel_kry)
    assert n_kry * 3 < n_plain, (n_kry, n_plain)
    # both solve the same system to relres 1e-10 -> solutions agree to
    # ~1e-10 of the GLOBAL solution scale (per-leaf scales are meaningless
    # for leaves that are ~0 at solution scale)
    scale = max(
        float(np.abs(np.asarray(a)).max())
        for a in jax.tree_util.tree_leaves(e_plain)
    )
    for a, b in zip(jax.tree_util.tree_leaves(e_plain),
                    jax.tree_util.tree_leaves(e_kry)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=0, atol=1e-8 * scale)
