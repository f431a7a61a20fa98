"""Domain decomposition: partitioner invariants + sharded solver semantics.

The sharded solver must reproduce the legacy MPI solver's block-Jacobi
semantics: exact Gauss-Seidel sweep within a partition, one-iteration-stale
coefficients across partition interfaces, halo exchange once per outer
iteration. The lagged-mode sequential oracle provides iterate-exact ground
truth (multi-device runs use the 8 virtual CPU devices from conftest).
"""

import numpy as np
import pytest

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.parallel import partition as part_mod
from pbte.solver.source_iteration import SourceIterationSolver
from pbte.validation.oracle import solve_oracle
from pbte.validation.partition import validate

BCS2D = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}


@pytest.fixture(scope="module")
def problem():
    m = pmesh.make_cartesian_2d(4, 4, pmesh.GEOM_TRIANGLE).scaled(1e-6)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=3)
    return m, topo, ops, quad, tables


@pytest.mark.parametrize("method", ["rcb", "greedy"])
@pytest.mark.parametrize("nparts", [2, 3, 4])
def test_partition_invariants(problem, method, nparts):
    _, topo, *_ = problem
    plan = part_mod.build_plan(topo, nparts, method=method)
    result = validate(plan, topo)
    assert result.ok, result.errors
    assert plan.load_balance() < 1.5


def test_rcb_balance_large():
    m = pmesh.make_cartesian_2d(16, 16, pmesh.GEOM_QUAD)
    topo = pmesh.connect(m)
    plan = part_mod.build_plan(topo, 8)
    assert plan.load_balance() == 1.0  # 256 elements split 8 ways evenly
    assert validate(plan, topo).ok


def _device_mesh(n_dir, n_space):
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[: n_dir * n_space]).reshape(n_dir, n_space)
    return Mesh(devs, axis_names=("dir", "space"))


def test_spatial_sharded_matches_lagged_oracle(problem):
    from pbte.parallel.spatial import SpatialShardedSolver

    m, topo, ops, quad, tables = problem
    mesh = _device_mesh(2, 4)
    solver = SpatialShardedSolver(
        ops, quad, tables, BCS2D, device_mesh=mesh, topo=topo
    )
    # iterate-exact ground truth: sequential oracle with the same partition
    uo, Tco, Tvo, _, _ = solve_oracle(
        ops, quad, tables, BCS2D, tol=0, max_iter=4, part=solver.pplan.part
    )

    u, Tc, Tv = solver.initial_state()
    prev = Tv
    for _ in range(4):
        u, Tc_new, Tv_new, r = solver.step(u, Tc, prev)
        prev, Tc = Tv_new, Tc_new

    Tc_glob = solver.gather_Tc(Tc)
    np.testing.assert_allclose(Tc_glob, Tco, rtol=1e-10, atol=1e-14)


def test_spatial_sharded_single_partition_equals_gauss_seidel(problem):
    """With one spatial partition there is nothing to lag: must equal the
    plain (full Gauss-Seidel) solver exactly."""
    from pbte.parallel.spatial import SpatialShardedSolver

    m, topo, ops, quad, tables = problem
    mesh = _device_mesh(4, 1)
    solver = SpatialShardedSolver(
        ops, quad, tables, BCS2D, device_mesh=mesh, topo=topo
    )
    uo, Tco, _, _, _ = solve_oracle(ops, quad, tables, BCS2D, tol=0, max_iter=3)
    u, Tc, Tv = solver.initial_state()
    prev = Tv
    for _ in range(3):
        u, Tc_new, Tv_new, r = solver.step(u, Tc, prev)
        prev, Tc = Tv_new, Tc_new
    np.testing.assert_allclose(solver.gather_Tc(Tc), Tco, rtol=1e-10, atol=1e-14)


def test_spatial_and_plain_share_fixed_point(problem):
    """Block-Jacobi and Gauss-Seidel converge to the same fixed point.

    Uses `consistent` face operators: the reference's rank-one (stale
    IntegrationPoint) face operators are numerically UNSTABLE on refined
    meshes — even pure Gauss-Seidel stalls at residual ~0.19 on this
    32-element mesh (measured via the sequential oracle), so the parity mode
    exists only to reproduce the committed 2-element goldens."""
    from pbte.parallel.spatial import SpatialShardedSolver
    from pbte.solver.source_iteration import SourceIterationSolver

    m, topo, ops_parity, quad, tables = problem
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    mesh = _device_mesh(2, 4)
    sp = SpatialShardedSolver(ops, quad, tables, BCS2D, device_mesh=mesh, topo=topo)
    rp = sp.solve(tol=1e-9, max_iter=1200, verbose=False, check_every=50)
    ss = SourceIterationSolver(ops, quad, tables, BCS2D)
    rs = ss.solve(tol=1e-9, max_iter=1200, verbose=False, check_every=50)
    assert rp.residual < 1e-6 and rs.residual < 1e-6
    np.testing.assert_allclose(
        sp.gather_Tc(rp.Tc), np.asarray(rs.Tc), rtol=1e-4, atol=1e-7
    )


def test_band_sharding_lifts_km_ceiling():
    """P(dir, band) sharding: 8 devices on a problem with Km=4 slots — the
    band axis supplies the extra parallel dimension.
    Padded bands carry zero tables and must not perturb the solution."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, axis_names=("dir", "band"))
    sharding = NamedSharding(mesh, P("dir", "band"))

    m = pmesh.make_cartesian_2d(3, 3, pmesh.GEOM_TRIANGLE).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=3)  # BS=6 -> pads ok
    bcs = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
    s = SourceIterationSolver(ops, quad, tables, bcs, dir_sharding=sharding)
    assert s.BS % 2 == 0 and s.BS >= s.BS_orig
    res = s.solve(tol=0, max_iter=5, verbose=False)

    s_ref = SourceIterationSolver(ops, quad, tables, bcs)
    ref = s_ref.solve(tol=0, max_iter=5, verbose=False)
    np.testing.assert_allclose(
        np.asarray(res.Tc), np.asarray(ref.Tc), rtol=1e-10, atol=1e-14
    )
    # direction-major views drop band padding
    assert s.u_by_direction(res.u).shape == s_ref.u_by_direction(ref.u).shape


@pytest.mark.parametrize("sweep_mode", ["ring", "scan"])
def test_dir_sharded_step_compiles_once(sweep_mode):
    """The initial state carries the shardings the step gives its outputs,
    so later steps reuse the first step's executable (a mismatch compiles
    the step a second time on its second call)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("dir",))
    m = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    s = SourceIterationSolver(ops, quad, tables, bcs, sweep_mode=sweep_mode,
                              dir_sharding=NamedSharding(mesh, P("dir")))
    assert s.sweep_mode == sweep_mode
    state = s.initial_state()
    for _ in range(3):
        *state, _ = s.step(*state)
    assert s._step._cache_size() == 1


def test_ppermute_halo_matches_psum():
    """The neighbor-to-neighbor (ppermute) halo must produce the same
    iterates as the legacy all-reduce halo (and the lagged oracle)."""
    import jax
    from jax.sharding import Mesh

    from pbte.parallel.spatial import SpatialShardedSolver

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    dmesh = Mesh(devs, axis_names=("dir", "space"))
    m = pmesh.make_cartesian_2d(4, 4, pmesh.GEOM_TRIANGLE).scaled(1e-6)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
    out = {}
    for mode in ("ppermute", "psum"):
        s = SpatialShardedSolver(ops, quad, tables, bcs, device_mesh=dmesh,
                                 topo=topo, halo_mode=mode)
        res = s.solve(tol=0, max_iter=6, verbose=False)
        out[mode] = s.gather_Tc(res.Tc)
    np.testing.assert_allclose(out["ppermute"], out["psum"],
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("method", ["rcb-fm", "greedy-fm"])
@pytest.mark.parametrize("nparts", [2, 4])
def test_partition_invariants_fm(problem, method, nparts):
    """FM-refined plans must still satisfy all 7 partition invariants."""
    _, topo, *_ = problem
    plan = part_mod.build_plan(topo, nparts, method=method)
    result = validate(plan, topo)
    assert result.ok, result.errors
    assert plan.load_balance() <= 1.1


def test_fm_refinement_reduces_edge_cut_unstructured_tet():
    """On a refined 3D tet mesh, the FM pass must not increase the RCB edge
    cut (it typically reduces it), keep balance <= 1.1, and the plan metrics
    must agree with a direct recount."""
    m = pmesh.make_cartesian_3d(3, 3, 3, "tet")
    m = pmesh.uniform_refine(m)  # 6*27*8 = 1296 tets
    topo = pmesh.connect(m)
    cuts = {}
    for method in ("rcb", "rcb-fm"):
        plan = part_mod.build_plan(topo, 4, method=method)
        assert validate(plan, topo).ok
        assert plan.load_balance() <= 1.1
        cuts[method] = plan.edge_cut()
        # plan metric == direct recount on the part vector
        assert plan.edge_cut() == part_mod.edge_cut(
            topo.elem_neighbor, plan.part
        )
    assert cuts["rcb-fm"] <= cuts["rcb"]
    assert cuts["rcb-fm"] < 1296  # sanity: far below total faces


@pytest.mark.parametrize("nparts", [2, 4])
def test_partition_invariants_multilevel(problem, nparts):
    """Multilevel (SHEM + FM, the METIS recipe) plans must satisfy all 7
    partition invariants with bounded imbalance."""
    _, topo, *_ = problem
    plan = part_mod.build_plan(topo, nparts, method="multilevel")
    result = validate(plan, topo)
    assert result.ok, result.errors
    assert plan.load_balance() <= 1.1


def test_multilevel_beats_or_matches_rcb_fm_edge_cut():
    """The multilevel partitioner (SHEM coarsening + per-level weighted FM —
    the METIS k-way recipe the reference calls, SpatialMesh.hpp:638-709)
    must produce an edge cut no worse than single-level RCB+FM on a refined
    unstructured tet mesh, with balance <= 1.05 (METIS ufactor=30 flavor)."""
    m = pmesh.make_cartesian_3d(3, 3, 3, "tet")
    m = pmesh.uniform_refine(m)  # 1296 tets
    topo = pmesh.connect(m)
    cuts = {}
    for method in ("rcb", "rcb-fm", "multilevel"):
        plan = part_mod.build_plan(topo, 4, method=method)
        assert validate(plan, topo).ok
        cuts[method] = plan.edge_cut()
    plan_ml = part_mod.build_plan(topo, 4, method="multilevel")
    assert plan_ml.load_balance() <= 1.05
    assert cuts["multilevel"] <= cuts["rcb-fm"] <= cuts["rcb"]


def test_multilevel_coarsening_preserves_totals():
    """SHEM coarsening must conserve total vertex weight and total edge
    weight across levels (no lost or duplicated faces)."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "tet")
    topo = pmesh.connect(m)
    g = part_mod._graph_from_neighbor(topo.elem_neighbor)
    rng = np.random.default_rng(0)
    vtot, etot = int(g[3].sum()), int(g[2].sum())
    for _ in range(4):
        res = part_mod._coarsen_shem(*g, rng)
        if res is None:
            break
        cxadj, cadjncy, cadjwgt, cvwgt, cmap = res
        assert int(cvwgt.sum()) == vtot
        # coarse edge weight + weight collapsed into matched pairs == total
        fine_internal = etot - int(cadjwgt.sum())
        assert fine_internal >= 0
        assert len(cvwgt) < len(g[3])
        assert (cxadj[1:] >= cxadj[:-1]).all()
        assert (cmap >= 0).all() and cmap.max() == len(cvwgt) - 1
        g = (cxadj, cadjncy, cadjwgt, cvwgt)
        etot = int(cadjwgt.sum())


def test_greedy_assigns_every_element_balanced():
    """The greedy partitioner must not dump BFS leftovers into one part
    (round-2 weak #5): every element assigned, balance bounded."""
    m = pmesh.make_cartesian_3d(4, 4, 4, "tet")
    topo = pmesh.connect(m)
    for nparts in (3, 5, 7):
        part = part_mod.partition_greedy_graph(topo.elem_neighbor, nparts)
        assert (part >= 0).all()
        counts = np.bincount(part, minlength=nparts)
        ne = topo.elem_neighbor.shape[0]
        assert counts.max() <= -(-ne // nparts) + 1


@pytest.mark.parametrize("flavor", ["cross", "local"])
def test_spatial_sharded_periodic_dirichlet_oracle(flavor):
    """Periodic wrap + Dirichlet faces on the unstructured DD path:
    periodic partners are read lagged whether
    cross-partition (halo buffer) or partition-local (pre-sweep snapshot),
    Dirichlet is a static source — iterate-exact against the sequential
    lagged oracle. The two flavors pick partitions that route the wrap
    through each path."""
    from pbte.parallel.spatial import SpatialShardedSolver

    if flavor == "cross":
        # 4 parts of a square mesh: RCB splits x, every x-wrap pair crosses
        m = pmesh.make_cartesian_2d(4, 4, pmesh.GEOM_TRIANGLE).scaled(1e-6)
        n_space = 4
    else:
        # 2 parts of a tall mesh: RCB splits y, every x-wrap pair is local
        m = pmesh.make_cartesian_2d(4, 8, pmesh.GEOM_TRIANGLE).scaled(1e-6)
        n_space = 2
    m = pmesh.make_periodic(m, [0])  # wrap x: attrs 2/4 disappear
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=3)
    attrs = sorted(int(a) for a in np.unique(ops.face_attr[ops.neighbor < 0]))
    top = max(attrs)
    bcs = {a: -0.5 for a in attrs if a != top}

    mesh = _device_mesh(2, n_space)
    solver = SpatialShardedSolver(
        ops, quad, tables, bcs, device_mesh=mesh, topo=topo,
        dirichlet_bcs={top: 0.25},
    )
    assert solver.has_periodic and solver.has_dirichlet
    per_e, per_f = np.nonzero(ops.periodic)
    cross = solver.pplan.part[per_e] != solver.pplan.part[
        ops.neighbor[per_e, per_f]
    ]
    assert cross.all() if flavor == "cross" else not cross.any()

    uo, Tco, *_ = solve_oracle(
        ops, quad, tables, bcs, tol=0, max_iter=4,
        part=solver.pplan.part, dirichlet={top: 0.25},
    )
    u, Tc, Tv = solver.initial_state()
    prev = Tv
    for _ in range(4):
        u, Tc_new, Tv_new, r = solver.step(u, Tc, prev)
        prev, Tc = Tv_new, Tc_new
    np.testing.assert_allclose(solver.gather_Tc(Tc), Tco, rtol=1e-10,
                               atol=1e-14)


def test_multilevel_balance_at_depth():
    """Balance regression guard at real coarsening depth: with enough SHEM
    levels the coarse greedy partition is imbalanced, and gain-only FM can
    never repair it (no positive-gain move leaves an overweight part) —
    measured 1.61 max/avg at ne=105k before the explicit balancing sweep.
    Small meshes never coarsen enough to expose it."""
    m = pmesh.make_cartesian_3d(16, 16, 16, "tet")
    topo = pmesh.connect(m)
    plan = part_mod.build_plan(topo, 8, method="multilevel")
    assert plan.load_balance() <= 1.1, plan.local_counts


def test_native_partitioner_quality_and_fallback():
    """The C++ multilevel partitioner (native/partition_native.cpp — the
    production path; the reference links METIS natively too) must satisfy
    the same contracts as the numpy twin (balance cap, valid part ids) and
    not regress its edge cut by more than 25% — measured at 26^3 tets it
    is strictly BETTER (cut 5325 vs 8548) and ~100x faster. The numpy
    fallback stays selectable via PBTE_PARTITION_NATIVE=0."""
    import os

    from pbte import native

    m = pmesh.make_cartesian_3d(10, 10, 10, "tet")
    topo = pmesh.connect(m)
    nat = native.partition_multilevel(topo.elem_neighbor, 6)
    if nat is None:
        pytest.skip("native toolchain unavailable")
    cn = np.bincount(nat, minlength=6)
    assert nat.min() >= 0 and nat.max() == 5
    assert cn.max() / cn.mean() <= 1.1
    os.environ["PBTE_PARTITION_NATIVE"] = "0"
    try:
        pyp = part_mod.partition_multilevel(topo.elem_neighbor, 6)
    finally:
        del os.environ["PBTE_PARTITION_NATIVE"]
    cut_nat = part_mod.edge_cut(topo.elem_neighbor, nat)
    cut_py = part_mod.edge_cut(topo.elem_neighbor, pyp)
    assert cut_nat <= 1.25 * cut_py, (cut_nat, cut_py)


def test_spatial_bicgstab_accelerated():
    """Krylov acceleration over the general-mesh sharded state."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pbte.parallel.spatial import SpatialShardedSolver

    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    m = pmesh.make_cartesian_2d(8, 6, pmesh.GEOM_TRIANGLE).scaled(1e-6)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh2 = Mesh(devs, axis_names=("dir", "space"))
    bcs = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
    s = SpatialShardedSolver(ops, quad, tables, bcs, device_mesh=mesh2,
                             topo=topo, dtype=jnp.float64)
    r_plain = s.solve(tol=1e-10, max_iter=2000, verbose=False,
                      check_every=20)
    r_acc = s.solve(tol=1e-10, max_iter=2000, verbose=False, check_every=20,
                    accelerate="bicgstab")
    assert r_acc.iterations * 2 < r_plain.iterations, (
        r_acc.iterations, r_plain.iterations)
    Tp, Ta = r_plain.Tc_global(), r_acc.Tc_global()
    np.testing.assert_allclose(Ta, Tp, rtol=0, atol=1e-7 * np.abs(Tp).max())


def test_spatial_reflective_bcs_match_single_device():
    """Diffuse (type 2) + specular (type 3) on the domain-decomposed solver:
    the diffuse hemisphere flux psums over the "dir" axis and the specular
    mirror slot is fetched via all_gather, both from the lagged pre-sweep
    state — so the sharded fixed point must equal the single-device one.
    Solved via the Krylov outer loop (same sharded step, ~6x fewer steps)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pbte.parallel.spatial import SpatialShardedSolver

    m = pmesh.make_cartesian_2d(6, 4, "quad").scaled(1e-6)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {2: 0.5, 4: -0.5}  # bottom diffuse, top specular (y-mirror ok)

    s0 = SourceIterationSolver(ops, quad, tables, bcs, dtype=jnp.float64,
                               diffuse_bcs=[1], specular_bcs=[3])
    r0 = s0.solve(tol=1e-11, max_iter=5000, verbose=False, check_every=20,
                  accelerate="bicgstab")
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    s1 = SpatialShardedSolver(ops, quad, tables, bcs,
                              device_mesh=Mesh(devs, ("dir", "space")),
                              topo=topo, dtype=jnp.float64,
                              diffuse_bcs=[1], specular_bcs=[3])
    r1 = s1.solve(tol=1e-11, max_iter=5000, verbose=False, check_every=20,
                  accelerate="bicgstab")
    T0, T1 = np.asarray(r0.Tc), s1.gather_Tc(r1.Tc)
    np.testing.assert_allclose(T1, T0, rtol=0, atol=1e-8 * np.abs(T0).max())


def test_spatial_class_factors_match_per_element():
    """Class-batched transport factors (canonical-face classes) produce the
    SAME iterates as the per-element A^-1 cache — the path that made
    flagship-scale domain decomposition affordable (per-element was the
    r2/r3 38 GB blocker). Tet mesh so raw face order would over-split."""
    from pbte.parallel.spatial import SpatialShardedSolver

    m = pmesh.make_cartesian_3d(3, 3, 3, "tet").scaled(1e-6)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    mesh_dev = _device_mesh(2, 4)
    runs = {}
    for force in (False, True):
        s = SpatialShardedSolver(
            ops, quad, tables, bcs, mesh_dev, topo=topo,
            partition_method="multilevel",
            force_per_element_factors=force,
        )
        if not force:
            assert s._spatial_cls is not None
            assert int(s._spatial_cls.max()) + 1 == 6  # the 6-tet classes
        else:
            assert s._spatial_cls is None
        u, Tc, Tv = s.initial_state()
        for _ in range(3):
            u, Tc, Tv, r = s.step(u, Tc, Tv)
        runs[force] = (s.gather_Tc(Tc), float(r))
    Tc_cls, r_cls = runs[False]
    Tc_pe, r_pe = runs[True]
    scale = np.abs(Tc_pe).max()
    assert np.abs(Tc_cls - Tc_pe).max() < 1e-12 * scale
    assert abs(r_cls - r_pe) < 1e-12


@pytest.mark.slow
def test_spatial_class_factors_production_scale():
    """Production-scale unstructured domain decomposition: a 24^3 6-tet
    mesh (82,944 elements, the scale of the
    reference's MPI workloads, ref: reference/DGSolver/
    PBTE_NonGraySMRT_MPI.cpp:403-506) partitioned by the native multilevel
    partitioner, swept with class-batched factors on a ("dir","space")
    device mesh. The per-element A^-1 cache at this shape would need tens
    of GB (asserted, not allocated); the class cache is a few MB."""
    from pbte.parallel.spatial import SpatialShardedSolver

    n = 24
    m = pmesh.make_cartesian_3d(n, n, n, "tet").scaled(1e-6)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=2, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=2, azimuth_points=4))
    tables = mat.build_tables(mat.SILICON, num_spectral=2)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    mesh_dev = _device_mesh(2, 4)
    s = SpatialShardedSolver(
        ops, quad, tables, bcs, mesh_dev, topo=topo,
        partition_method="multilevel",
    )
    assert s._spatial_cls is not None
    ncls = int(s._spatial_cls.max()) + 1
    assert ncls <= 24
    # the per-element cache this replaces (not allocated): >4 GB at this
    # test's 4-band subset, >40 GB at the production 2x20-band spectrum
    per_elem_bytes = (
        s.pplan.nparts * s.G * s.Km * s.BS * s.D * s.D * s.pplan.ne_max * 8
    )
    assert per_elem_bytes > 4e9
    assert per_elem_bytes * (40 / s.BS) > 40e9
    cls_bytes = s.G * s.Km * s.BS * ncls * s.D * s.D * 8
    assert cls_bytes < 50e6
    u, Tc, Tv = s.initial_state()
    rs = []
    for _ in range(3):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        rs.append(float(r))
    assert np.isfinite(rs).all() and rs[2] < rs[1] < rs[0]
    Tc_g = s.gather_Tc(Tc)
    assert np.isfinite(Tc_g).all() and np.abs(Tc_g).max() > 0


def test_spatial_sharded_paraview_pieces(problem, tmp_path):
    """Distributed ParaView export from shard-local blocks: piece T/Q data
    must reassemble to the global gather_Tc / heat_flux fields (analog of the
    reference's per-rank ParGridFunction pieces,
    ref: src/MacroscopicQuantities.cpp:168-271)."""
    import xml.etree.ElementTree as ET

    from pbte.parallel.spatial import SpatialShardedSolver

    m, topo, ops, quad, tables = problem
    mesh = _device_mesh(2, 4)
    solver = SpatialShardedSolver(
        ops, quad, tables, BCS2D, device_mesh=mesh, topo=topo
    )
    u, Tc, Tv = solver.initial_state()
    for _ in range(3):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)

    pieces = solver.paraview_pieces(Tc, u)
    assert len(pieces) == solver.pplan.nparts
    Tc_g = solver.gather_Tc(Tc)
    Qc_g, _ = solver.heat_flux(u)
    covered = np.zeros(solver.ne, dtype=bool)
    for ids, sf, vf in pieces:
        assert not covered[ids].any()
        covered[ids] = True
        assert np.allclose(sf["T"], Tc_g[ids], atol=1e-12)
        assert np.allclose(vf["Q"], Qc_g[:, ids], atol=1e-12)
    assert covered.all()

    pvd = solver.write_paraview(Tc, u, name="dd", root=str(tmp_path),
                                cycle=3)
    assert pvd.endswith("dd.pvd")
    cdir = tmp_path / "dd" / "Cycle000003"
    pv = ET.parse(cdir / "data.pvtu").getroot()
    srcs = [p.get("Source") for p in pv.findall(".//Piece")]
    assert srcs == [f"proc{p:06d}.vtu" for p in range(solver.pplan.nparts)]
    for p in range(solver.pplan.nparts):
        assert (cdir / f"proc{p:06d}.vtu").exists()
