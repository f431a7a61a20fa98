"""Native C++ sweep kernels vs the numpy reference implementations."""

import numpy as np
import pytest

from pbte import mesh as pmesh, native
from pbte.angular import quadrature as ang
from pbte.sweep import planner


@pytest.fixture(scope="module")
def problem():
    m = pmesh.make_cartesian_2d(6, 5, pmesh.GEOM_TRIANGLE)
    topo = pmesh.connect(m)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=16))
    return topo, quad


def _numpy_levels(neighbor, normals, dirs):
    """The pure-numpy fixpoint (the planner's fallback path, inlined here so
    the comparison does not depend on which backend the planner picked)."""
    K = dirs.shape[0]
    ne, nf = neighbor.shape
    inflow = planner.upwind_inflow(neighbor, normals, dirs)
    nbr_safe = np.where(neighbor >= 0, neighbor, 0)
    level = np.zeros((K, ne), dtype=np.int64)
    for _ in range(ne + 1):
        cand = np.where(inflow, level[:, nbr_safe] + 1, 0)
        new = cand.max(axis=-1)
        if np.array_equal(new, level):
            return level.astype(np.int32)
        level = new
    raise RuntimeError("cycle")


def test_native_builds():
    assert native.get_lib() is not None, "native sweep library failed to build"


def test_native_levels_match_numpy(problem):
    topo, quad = problem
    got = native.compute_levels(topo.elem_neighbor, topo.normals, quad.directions)
    want = _numpy_levels(topo.elem_neighbor, topo.normals, quad.directions)
    np.testing.assert_array_equal(got, want)


def test_native_greedy_matches_semantics(problem):
    topo, quad = problem
    got = native.greedy_orders(topo.elem_neighbor, topo.normals, quad.directions)
    # validity: each element appears once, upwind deps before it
    inflow = planner.upwind_inflow(topo.elem_neighbor, topo.normals, quad.directions)
    ne = topo.mesh.num_elements
    for k in range(quad.num_directions):
        order = got[k]
        assert sorted(order) == list(range(ne))
        position = np.empty(ne, dtype=int)
        position[order] = np.arange(ne)
        for e in range(ne):
            for f in range(topo.faces_per_elem):
                if inflow[k, e, f]:
                    assert position[topo.elem_neighbor[e, f]] < position[e]


def test_native_signatures_match_packbits(problem):
    topo, quad = problem
    got = native.inflow_signatures(topo.elem_neighbor, topo.normals, quad.directions)
    inflow = planner.upwind_inflow(topo.elem_neighbor, topo.normals, quad.directions)
    want = np.packbits(inflow.reshape(quad.num_directions, -1), axis=1)
    np.testing.assert_array_equal(got, want)


def test_native_cycle_detection():
    neighbor = np.array([[1, -1], [2, -1], [0, -1]], dtype=np.int32)
    normals = np.tile(np.array([[[-1.0, 0.0]]]), (3, 2, 1))
    dirs = np.array([[1.0, 0.0, 0.0]])
    with pytest.raises(ValueError):
        native.compute_levels(neighbor, normals, dirs)
    with pytest.raises(ValueError):
        native.greedy_orders(neighbor, normals, dirs)


# ---------------------------------------------------------------------------
# C++ reference-mirror source-iteration solver (the measured bench baseline)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solver_problem():
    from pbte.fem import assembly
    from pbte.material import nongray_smrt as mat

    m = pmesh.make_cartesian_2d(3, 3, pmesh.GEOM_TRIANGLE).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
    return ops, quad, tables, bcs


def test_cpp_solver_matches_oracle(solver_problem):
    """The C++ baseline must reproduce the Python oracle bit-for-bit-ish:
    same algorithm (lagged-Tc source iteration, upwind sweeps, dense LU),
    f64 throughout (ref: src/PBTESolver.cpp:208-332)."""
    from pbte.validation.oracle import solve_oracle

    ops, quad, tables, bcs = solver_problem
    out = native.cpp_source_iteration(ops, quad, tables, bcs, 5)
    assert out is not None, "C++ solver library failed to build"
    u, Tc, Tv, resid, secs = out
    uo, Tco, Tvo, reso, _ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=5)
    np.testing.assert_allclose(Tc, Tco, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(u, uo, rtol=1e-12, atol=1e-22)
    np.testing.assert_allclose(Tv, Tvo, rtol=1e-12)
    assert (secs > 0).all()


def test_cpp_solver_cache_policies_agree(solver_problem):
    """FullLU cache vs on-the-fly factorization: same numbers."""
    ops, quad, tables, bcs = solver_problem
    a = native.cpp_source_iteration(ops, quad, tables, bcs, 3, use_full_lu=True)
    b = native.cpp_source_iteration(ops, quad, tables, bcs, 3, use_full_lu=False)
    if a is None or b is None:
        pytest.skip("C++ solver library unavailable")
    np.testing.assert_allclose(a[0], b[0], rtol=1e-13, atol=1e-24)


def test_cpp_solver_resumes_from_state(solver_problem):
    """5 iterations == 3 then 2 more from the returned state."""
    ops, quad, tables, bcs = solver_problem
    full = native.cpp_source_iteration(ops, quad, tables, bcs, 5)
    if full is None:
        pytest.skip("C++ solver library unavailable")
    part = native.cpp_source_iteration(ops, quad, tables, bcs, 3)
    resumed = native.cpp_source_iteration(
        ops, quad, tables, bcs, 2, state=(part[0], part[1], part[2])
    )
    np.testing.assert_allclose(resumed[1], full[1], rtol=1e-13, atol=1e-24)
