"""Ring sweep mode: padded slab scan with one-hot neighbor matmuls and
class-batched dense transport factors (the fast path; see
solver/source_iteration.py sweep_mode="ring")."""

import numpy as np
import pytest

import jax.numpy as jnp

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.solver.source_iteration import SourceIterationSolver
from pbte.validation.oracle import solve_oracle

BCS3 = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}
BCS2 = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}


def _solve_both(m, dim, bcs, order, niter=4, nspec=2, **kw):
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    opts = (ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4)
            if dim == 3 else ang.AngularOptions(dimension=2, azimuth_points=8))
    quad = ang.build(opts)
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                              sweep_mode="ring", **kw)
    assert s.sweep_mode == "ring"
    res = s.solve(tol=0, max_iter=niter, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=niter)
    return s, res, Tco


def test_ring_hex_single_class():
    """Canonical face ordering collapses hex to ONE class; ring sweep must
    match the oracle to machine precision."""
    m = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(1e-6)
    s, res, Tco = _solve_both(m, 3, BCS3, order=1)
    assert s.ncls_ring == 1 and s._canonical_faces and s._ring_ccpl
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-12, atol=1e-14)


def test_ring_tet_multi_class():
    """6-tet meshes keep several geometry classes (H=2 ring depth); the
    class-mixed apply and per-element coupling stream must still be exact."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "tet").scaled(1e-6)
    s, res, Tco = _solve_both(m, 3, BCS3, order=2)
    assert s.ncls_ring > 1 and s._ring_H >= 2
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-12, atol=1e-14)


def test_ring_quad_2d():
    m = pmesh.make_cartesian_2d(9, 8, "quad").scaled(1e-6)
    s, res, Tco = _solve_both(m, 2, BCS2, order=2)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-12, atol=1e-14)


def test_ring_periodic():
    """Lagged periodic coupling folds into rhs_base before the ring scan."""
    m = pmesh.make_cartesian_2d(4, 3, "quad").scaled(1e-6)
    m = pmesh.make_periodic(m, [0])
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {1: -0.5, 3: 0.5}
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                              sweep_mode="ring")
    assert s.sweep_mode == "ring" and s.has_periodic
    res = s.solve(tol=0, max_iter=6, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=6)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_ring_auto_picks_scan_for_tiny():
    """auto mode keeps the compact scan on tiny meshes (golden byte parity)."""
    m = pmesh.make_cartesian_2d(3, 3, "triangle").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS2)
    assert s.sweep_mode == "scan" and not s._canonical_faces


def test_ring_state_roundtrip_views():
    """u_by_direction and heat_flux work on the padded ring state."""
    m = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(1e-6)
    s, res, Tco = _solve_both(m, 3, BCS3, order=1)
    ud = s.u_by_direction(res.u)
    assert ud.shape == (s.K, s.BS, s.ne, s.D)
    assert np.isfinite(ud).all()
    Qc, Qv = s.heat_flux(res.u)
    total = np.asarray(Qv).sum(axis=1)
    assert total[2] < 0  # heat flows downward from the hot top z-face


def test_ring_with_dir_sharding():
    """Ring mode under ordinate sharding on the virtual device mesh."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, axis_names=("dir",))
    sharding = NamedSharding(mesh, P("dir"))
    m = pmesh.make_cartesian_2d(6, 6, pmesh.GEOM_QUAD).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS2, dtype=jnp.float64,
                              sweep_mode="ring", dir_sharding=sharding)
    assert s.sweep_mode == "ring"
    res = s.solve(tol=0, max_iter=5, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, BCS2, tol=0, max_iter=5)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-10, atol=1e-14)


def test_ring_checkpoint_roundtrip(tmp_path):
    """Bucketed ring state saves/loads; resumed run == uninterrupted run."""
    from pbte.io.checkpoint import load_checkpoint, save_checkpoint

    m = pmesh.make_cartesian_3d(6, 6, 6, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    assert isinstance(s.initial_state()[0], tuple)
    full = s.solve(tol=0, max_iter=6, verbose=False)
    half = s.solve(tol=0, max_iter=3, verbose=False)
    ck = str(tmp_path / "ring.npz")
    save_checkpoint(ck, s, half.u, half.Tc, half.Tv, 3, half.residual)
    state, it, _ = load_checkpoint(ck, s)
    resumed = s.solve(tol=0, max_iter=3, verbose=False, state=state)
    np.testing.assert_allclose(
        np.asarray(resumed.Tc), np.asarray(full.Tc), rtol=1e-12, atol=1e-15
    )


def test_ring_lattice_matches_onehot():
    """The shift-structured lattice ring (no one-hot selection) must agree
    with the general one-hot ring to machine precision on hex/quad lattices,
    including periodic wrap and Dirichlet faces."""
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    # 3D hex with a periodic axis and a Dirichlet face
    m = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(1e-6)
    m = pmesh.make_periodic(m, [0])
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    bcs = {1: -0.5, 2: -0.5, 4: -0.5}
    kw = dict(dtype=jnp.float64, sweep_mode="ring",
              dirichlet_bcs={6: 0.25})
    s_lat = SourceIterationSolver(ops, quad, tables, bcs, **kw)
    assert s_lat._ring_lattice and s_lat.has_periodic and s_lat.has_dirichlet
    assert s_lat._ring_shift_vals == (0, 8, 1)
    s_oh = SourceIterationSolver(ops, quad, tables, bcs, use_lattice=False,
                                 **kw)
    assert s_oh.sweep_mode == "ring" and not s_oh._ring_lattice
    r_lat = s_lat.solve(tol=0, max_iter=5, verbose=False)
    r_oh = s_oh.solve(tol=0, max_iter=5, verbose=False)
    # fp summation order differs (faces summed by axis vs one matmul)
    np.testing.assert_allclose(
        np.asarray(r_lat.Tc), np.asarray(r_oh.Tc), rtol=1e-10, atol=0
    )


def test_ring_lattice_2d_oracle():
    """2D quad lattice ring vs the dense oracle (>=512 elements so the
    canonical face ordering and lattice detection both engage)."""
    m = pmesh.make_cartesian_2d(32, 24, "quad").scaled(1e-6)
    s, res, Tco = _solve_both(m, 2, BCS2, order=1)
    assert s._ring_lattice and s._ring_shift_vals == (0, 1)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-12, atol=1e-14)


def test_ring_lattice_padded_slots_stay_zero():
    """Padded slab slots are exact zero fixed points (no garbage growth
    over long runs — the lagged-Tc source is masked by valid_slab)."""
    m = pmesh.make_cartesian_3d(16, 8, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    assert s._ring_lattice
    res = s.solve(tol=0, max_iter=8, verbose=False)
    # layout-agnostic check via the standard slot view (windowed mode pastes
    # hull windows into a zeroed rectangle; in-window padded slots must have
    # stayed exactly zero through the iterations)
    us = s._ring_u_standard(res.u)  # (G, Km, BS, D, ne_pad)
    pad = ~s._pos_valid  # (G, ne_pad)
    vals = np.moveaxis(us, (0, 4), (0, 1))[pad]
    assert vals.size and np.all(vals == 0.0)


def test_ring_stretched_lattice_multiclass_oracle():
    """Graded (stretched) Cartesian hex: still a lattice, but one geometry
    class per x-layer with per-element couplings (exercises the pre-shifted
    coupling slabs). Also a regression test for the element_classes
    per-part quantization scale: a single global scale made the O(volume)
    operators invisible next to the O(1) normals and falsely merged
    different-sized elements (1e11 relative field error vs the oracle)."""
    import dataclasses

    m = pmesh.make_cartesian_3d(8, 8, 8, "hex")
    v = m.vertices.copy()
    v[:, 0] = v[:, 0] ** 2  # grade the x spacing
    m = dataclasses.replace(m, vertices=v).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    assert s._ring_lattice and s.ncls_ring == 8 and not s._ring_ccpl
    res = s.solve(tol=0, max_iter=4, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, BCS3, tol=0, max_iter=4)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-12,
                               atol=1e-14 * np.abs(Tco).max())


def test_ring_bf16_staging_close_to_f32():
    """bf16 operand staging (PBTE_RING_BF16=1): carry + xcat stored bf16.
    On CPU, where the f32 einsum is exact, it introduces exactly one extra
    bf16 rounding of the carried neighbor values — the field must stay
    within that noise class of the unstaged f32 ring."""
    import os

    m = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)

    def run(env_val):
        os.environ["PBTE_RING_BF16"] = env_val
        try:
            s = SourceIterationSolver(ops, quad, tables, BCS3,
                                      dtype=jnp.float32, sweep_mode="ring")
        finally:
            del os.environ["PBTE_RING_BF16"]
        assert s._ring_lattice
        assert s._ring_stage_bf16 == (env_val != "0")  # default ON
        return np.asarray(s.solve(tol=0, max_iter=5, verbose=False).Tc)

    Tc_bf16 = run("1")
    Tc_f32 = run("0")
    assert np.isfinite(Tc_bf16).all()
    scale = np.abs(Tc_f32).max()
    err = np.abs(Tc_bf16 - Tc_f32).max() / scale
    assert err < 3e-2, f"bf16 staging error {err:.2e} out of noise class"
    assert err > 0  # the staged path must actually run in bf16


def test_ring_windowed_matches_full_slab():
    """Hull-windowed lattice ring (per-segment 128-slot aligned windows +
    rewindowed carry) must equal the full-W slab ring bit-for-bit in f64 —
    windows only skip slots that are provably invalid (outside the
    wavefront hull), and the segment-entry carry frame must cover the
    previous level's hull (the _fit_ring_window correctness constraint).
    The mesh must have a >128-slot plane (16x16 = 256) or aligned windows
    cannot engage at all. A Dirichlet face exercises the windowed dsrc
    slabs alongside the isothermal bsrc ones."""
    import os

    m = pmesh.make_cartesian_3d(16, 16, 16, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {a: -0.5 for a in range(1, 6)}

    def run(env_val):
        os.environ["PBTE_RING_WINDOWS"] = env_val
        try:
            s = SourceIterationSolver(ops, quad, tables, bcs,
                                      dtype=jnp.float64, sweep_mode="ring",
                                      dirichlet_bcs={6: 0.25})
        finally:
            del os.environ["PBTE_RING_WINDOWS"]
        assert s.has_dirichlet
        assert s._ring_lattice
        assert s._ring_windowed == (env_val != "0")
        res = s.solve(tol=0, max_iter=3, verbose=False)
        return s, res

    s_w, r_w = run("1")
    slot_tot = sum((l1 - l0) * Ws for l0, l1, _, _, Ws in s_w._ring_segs)
    assert slot_tot < s_w.L * s_w.W  # windows actually shrink the slab
    for (_, _, o0, d, Ws) in s_w._ring_segs:
        assert d == 0 and o0 % 128 == 0  # aligned or not at all
        assert Ws % 128 == 0 or o0 + Ws == s_w.W
    s_f, r_f = run("0")
    # identical up to float summation ORDER. The tolerance is relative to
    # the FIELD SCALE, not per element: the legacy type-7 Dirichlet source
    # carries no heat_cap/omega normalization, so intensities reach ~1e8
    # and elements whose Tc is small by angular cancellation inherit
    # absolute reordering noise of eps * |u| (measured ~3e-16 of the
    # field scale; per-element rtol would demand the impossible there)
    Tw, Tf = np.asarray(r_w.Tc), np.asarray(r_f.Tc)
    np.testing.assert_allclose(
        Tw, Tf, rtol=1e-12, atol=1e-12 * np.abs(Tf).max()
    )
    uw = s_w._ring_u_standard(r_w.u)
    uf = s_f._ring_u_standard(r_f.u)
    np.testing.assert_allclose(
        uw, uf, rtol=1e-12, atol=1e-12 * np.abs(uf).max()
    )


def test_ring_windowed_with_dir_sharding():
    """Hull-windowed ring under ordinate sharding: the per-segment consts
    and the nested (bucket, segment) state must carry the NamedSharding.
    16^3 is the smallest plane where aligned windows can engage (the
    plane must exceed 128 slots)."""
    import os

    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:2])
    mesh = Mesh(devs, axis_names=("dir",))
    sharding = NamedSharding(mesh, P("dir"))
    m = pmesh.make_cartesian_3d(16, 16, 16, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    os.environ["PBTE_RING_BF16"] = "0"  # exact f32 for the A/B
    try:
        s = SourceIterationSolver(ops, quad, tables, BCS3,
                                  dtype=jnp.float32, sweep_mode="ring",
                                  dir_sharding=sharding)
        s0 = SourceIterationSolver(ops, quad, tables, BCS3,
                                   dtype=jnp.float32, sweep_mode="ring")
    finally:
        del os.environ["PBTE_RING_BF16"]
    assert s._ring_windowed and s0._ring_windowed
    r = s.solve(tol=0, max_iter=3, verbose=False)
    r0 = s0.solve(tol=0, max_iter=3, verbose=False)
    np.testing.assert_allclose(
        np.asarray(r.Tc), np.asarray(r0.Tc), rtol=1e-6, atol=1e-9
    )


def test_ring_windowed_checkpoint_roundtrip(tmp_path):
    """Hull-windowed ring state is a nested (bucket, segment) tuple saved
    as u_{i}_{s} npz fields; load_checkpoint must reassemble the nesting
    (a round-3 bug: the loader only knew the flat-bucket u_{i} layout, so
    every windowed checkpoint failed to resume). Resumed run == full run."""
    from pbte.io.checkpoint import load_checkpoint, save_checkpoint

    m = pmesh.make_cartesian_3d(16, 16, 16, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    assert s._ring_windowed  # 16x16 plane: aligned windows engage
    assert isinstance(s.initial_state()[0][0], tuple)  # nested state
    full = s.solve(tol=0, max_iter=4, verbose=False)
    half = s.solve(tol=0, max_iter=2, verbose=False)
    ck = str(tmp_path / "win.npz")
    save_checkpoint(ck, s, half.u, half.Tc, half.Tv, 2, half.residual)
    state, it, _ = load_checkpoint(ck, s)
    assert it == 2
    resumed = s.solve(tol=0, max_iter=2, verbose=False, state=state)
    np.testing.assert_allclose(
        np.asarray(resumed.Tc), np.asarray(full.Tc), rtol=1e-12, atol=1e-15
    )


def test_ring_state_bf16_close_to_f32():
    """bf16 STATE storage (PBTE_RING_STATE_BF16=1): the scan ys and the
    carried slabs between outer iterations are stored bf16 (halving the ys
    write + v_l read memory streams). On top of operand staging this adds one
    bf16 rounding of v between iterations — same noise class; the field
    must stay within it. Runs on the 16^3 WINDOWED path so the per-segment
    ys emission is covered too; checkpoint save/load round-trips the bf16
    state through the f32 npz encoding."""
    import os

    from pbte.io.checkpoint import load_checkpoint, save_checkpoint

    m = pmesh.make_cartesian_3d(16, 16, 16, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)

    def run(env):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            s = SourceIterationSolver(ops, quad, tables, BCS3,
                                      dtype=jnp.float32, sweep_mode="ring")
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        assert s._ring_lattice and s._ring_windowed
        return s, s.solve(tol=0, max_iter=3, verbose=False)

    s_b, r_b = run({"PBTE_RING_STATE_BF16": "1"})
    assert s_b._ring_state_bf16
    assert s_b.initial_state()[0][0][0].dtype == jnp.bfloat16
    assert r_b.u[0][0].dtype == jnp.bfloat16  # ys came back bf16
    s_f, r_f = run({"PBTE_RING_BF16": "0"})
    assert not s_f._ring_state_bf16 and not s_f._ring_stage_bf16
    Tb, Tf = np.asarray(r_b.Tc), np.asarray(r_f.Tc)
    assert np.isfinite(Tb).all()
    err = np.abs(Tb - Tf).max() / np.abs(Tf).max()
    assert 0 < err < 3e-2, f"bf16 state error {err:.2e} out of noise class"
    # host-side views upcast to f32
    assert s_b._ring_u_standard(r_b.u).dtype == np.float32
    # checkpoint: bf16 -> f32 npz -> bf16
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "bf16.npz")
        save_checkpoint(ck, s_b, r_b.u, r_b.Tc, r_b.Tv, 3, r_b.residual)
        state, it, _ = load_checkpoint(ck, s_b)
        assert state[0][0][0].dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(state[0][0][0], dtype=np.float32),
            np.asarray(r_b.u[0][0], dtype=np.float32),
        )


def test_polish_equals_extra_steps_f64():
    """solve(polish_iters=N) at f64 (where every precision is exact) must
    equal N extra plain iterations — the polish recipe's correctness; its
    VALUE is on an accelerator whose default precision rounds matmul
    operands, where the exact-precision tail contracts the field bias by
    rho^N (README, "Precision")."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    r1 = s.solve(tol=0, max_iter=105, verbose=False)
    r2 = s.solve(tol=0, max_iter=100, verbose=False, polish_iters=5)
    scale = np.abs(np.asarray(r1.Tc)).max()
    assert np.abs(np.asarray(r1.Tc) - np.asarray(r2.Tc)).max() < 1e-14 * scale
    assert r2.iterations == 105


def test_polish_extrapolation_accelerates_slow_modes():
    """Aitken extrapolation of the polish tail lands much closer to the
    fixed point than the same number of plain steps (the quasi-neutral
    offset family contracts at lambda ~= 1 and dominates the remaining
    error; two extra steps estimate its geometric ratio and jump to the
    limit)."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    ref = np.asarray(s.solve(tol=1e-13, max_iter=3000, verbose=False).Tc)
    plain = s.solve(tol=0, max_iter=200, verbose=False)
    extr = s.solve(tol=0, max_iter=180, verbose=False, polish_iters=18,
                   polish_extrapolate=True)
    e_plain = np.abs(np.asarray(plain.Tc) - ref).max()
    e_extr = np.abs(np.asarray(extr.Tc) - ref).max()
    assert e_extr < 0.1 * e_plain


def test_ring_fold_env_two_matmul_matches(monkeypatch):
    """PBTE_RING_FOLD=0 (two-matmul body on any lattice) must match the
    default folded body exactly — the shape-dependent A/B lever (folded
    body on hex lattices, two-matmul on supercells; ROADMAP 3.2)."""
    m = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    monkeypatch.setenv("PBTE_RING_FOLD", "0")
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                              sweep_mode="ring")
    assert not s._ring_fold
    r = s.solve(tol=0, max_iter=4, verbose=False)
    monkeypatch.delenv("PBTE_RING_FOLD")
    s2 = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float64,
                               sweep_mode="ring")
    assert s2._ring_fold
    r2 = s2.solve(tol=0, max_iter=4, verbose=False)
    scale = np.abs(np.asarray(r2.Tc)).max()
    assert np.abs(np.asarray(r.Tc) - np.asarray(r2.Tc)).max() < 1e-13 * scale


def test_ring_max_segs_env(monkeypatch):
    """PBTE_RING_MAX_SEGS caps the hull-window segment count (each segment
    compiles its own scan body, so the cap trades step time for cold-compile
    time; ROADMAP 3.3) and the capped solver still produces identical
    iterates."""
    m = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    s_def = SourceIterationSolver(ops, quad, tables, BCS3,
                                  dtype=jnp.float64, sweep_mode="ring")
    monkeypatch.setenv("PBTE_RING_MAX_SEGS", "2")
    s_cap = SourceIterationSolver(ops, quad, tables, BCS3,
                                  dtype=jnp.float64, sweep_mode="ring")
    if s_def._ring_windowed:
        assert s_cap._ring_segs is None or len(s_cap._ring_segs) <= 2
    r1 = s_def.solve(tol=0, max_iter=4, verbose=False)
    r2 = s_cap.solve(tol=0, max_iter=4, verbose=False)
    scale = np.abs(np.asarray(r1.Tc)).max()
    assert np.abs(np.asarray(r1.Tc) - np.asarray(r2.Tc)).max() < 1e-13 * scale
