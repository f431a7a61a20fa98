"""Dirichlet (legacy BC type 7): prescribed incoming intensity.

The reference wires FluxMat for type 7 (Reference Project/include/PolyFem/
PolyIntegral.hpp:299-321) but its solvers reject it at solve time and the
analytic-profile quadrature is commented out; this is the completed
semantics, validated solver-vs-oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.solver.source_iteration import SourceIterationSolver
from pbte.validation.oracle import solve_oracle


def _problem(nx=4, ny=3):
    m = pmesh.make_cartesian_2d(nx, ny, pmesh.GEOM_QUAD).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    return ops, quad, tables


def test_dirichlet_matches_oracle_scan():
    ops, quad, tables = _problem()
    bcs = {1: -0.5, 2: -0.5, 4: -0.5}
    diri = {3: 2.5e-9}  # top face: prescribed incoming intensity
    s = SourceIterationSolver(ops, quad, tables, bcs, dirichlet_bcs=diri,
                              dtype=jnp.float64, sweep_mode="scan")
    assert s.has_dirichlet and s.sweep_mode == "scan"
    res = s.solve(tol=0, max_iter=6, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=6,
                               dirichlet=diri)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-11, atol=1e-14)
    assert np.abs(Tco).max() > 0


def test_dirichlet_matches_oracle_ring():
    ops, quad, tables = _problem(5, 4)
    bcs = {1: -0.5, 2: -0.5, 4: -0.5}
    diri = {3: 1.0e-9}
    s = SourceIterationSolver(ops, quad, tables, bcs, dirichlet_bcs=diri,
                              dtype=jnp.float64, sweep_mode="ring")
    assert s.has_dirichlet and s.sweep_mode == "ring"
    res = s.solve(tol=0, max_iter=6, verbose=False)
    uo, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=6,
                               dirichlet=diri)
    np.testing.assert_allclose(np.asarray(res.Tc), Tco, rtol=1e-11, atol=1e-14)


def test_dirichlet_satisfies_bc_check():
    """Attrs covered by dirichlet_bcs pass the boundary sanity check."""
    ops, quad, tables = _problem()
    with pytest.raises(ValueError, match="without isothermal BC"):
        SourceIterationSolver(ops, quad, tables, {1: -0.5, 2: -0.5, 4: -0.5})
    SourceIterationSolver(ops, quad, tables, {1: -0.5, 2: -0.5, 4: -0.5},
                          dirichlet_bcs={3: 0.0})


def test_legacy_config_type7(tmp_path):
    from pbte.config import load_legacy_control

    p = tmp_path / "Control.yaml"
    p.write_text(
        "POLYDEG: 1\nSPATIAL_DIM: 2\nNAZIM: 8\nNSPEC: 4\n"
        "BOUNDARY_COND:\n  1: [1, -0.5]\n  3: [7, 1.5e-9]\n"
        "  2: [1, -0.5]\n  4: [1, -0.5]\n"
    )
    rc = load_legacy_control(str(p))
    assert rc.bc_temps == {1: -0.5, 2: -0.5, 4: -0.5}
    assert rc.dirichlet_bcs == {3: 1.5e-9}


def test_modern_config_dirichlet(tmp_path):
    from pbte.config import load_run_config

    p = tmp_path / "config.yaml"
    p.write_text(
        "boundary_conditions:\n"
        "  - {attr: 1, temperature: -0.5}\n"
        "  - {attr: 2, type: periodic}\n"
        "  - {attr: 3, type: dirichlet, value: 2.0e-9}\n"
        "  - {attr: 4, temperature: 0.5}\n"
    )
    rc = load_run_config(str(p))
    assert rc.bc_temps == {1: -0.5, 4: 0.5}
    assert rc.periodic_attrs == [2]
    assert rc.dirichlet_bcs == {3: 2.0e-9}
