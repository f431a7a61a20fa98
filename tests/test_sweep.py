"""Sweep planner parity + levelization properties.

Golden sources:
- output/log/sweep_dim2_np24_gauss_na24_gauss.txt  (2D angles, 8-elem mesh)
- output/log/sweep_dim3_np24_gauss_na24_gauss.txt  (3D angles, 8-elem mesh)
Both were produced from unit-square-iso.mesh refined once (8 triangles) —
matching them also validates the refinement element ordering vs MFEM's.
"""

import numpy as np
import pytest

from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.sweep import planner


def _parse_sweep(path):
    orders = []
    meta = {}
    for line in open(path):
        line = line.strip()
        if line.startswith(("dimension:", "elements:", "directions:")):
            k, v = line.split(":")
            meta[k] = int(v)
        elif line.startswith("dir "):
            head, _, tail = line.partition("order:")
            orders.append([int(x) for x in tail.split()])
    return meta, orders


def _topo(reference_root, refine):
    m = pmesh.load_mfem_mesh(str(reference_root / "config/mesh/unit-square-iso.mesh"))
    m = pmesh.uniform_refine(m.scaled(1.0e-6), refine)
    return pmesh.connect(m)


@pytest.fixture(scope="module")
def refined_topo(reference_root):
    return _topo(reference_root, 1)


# The committed sweep_dim2 log is the unrefined 2-elem mesh with 2D angles;
# sweep_dim3 is the once-refined 8-elem mesh with 3D angles (24x24=576 dirs).
@pytest.mark.parametrize("angdim,refine,ne", [(2, 0, 2), (3, 1, 8)])
def test_greedy_orders_match_golden(reference_root, angdim, refine, ne):
    meta, golden = _parse_sweep(
        reference_root / f"output/log/sweep_dim{angdim}_np24_gauss_na24_gauss.txt"
    )
    topo = _topo(reference_root, refine)
    assert meta["elements"] == ne == topo.mesh.num_elements
    quad = ang.build(ang.AngularOptions(dimension=angdim, polar_points=24, azimuth_points=24))
    assert quad.num_directions == meta["directions"]
    ours = planner.greedy_orders(
        topo.elem_neighbor, topo.normals, quad.directions
    )
    mismatches = sum(
        1 for k in range(len(golden)) if list(ours[k]) != golden[k]
    )
    assert mismatches == 0, f"{mismatches}/{len(golden)} direction orders differ"


def test_levels_respect_upwind_dependencies(refined_topo):
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=24))
    topo = refined_topo
    levels = planner.compute_levels(topo.elem_neighbor, topo.normals, quad.directions)
    inflow = planner.upwind_inflow(topo.elem_neighbor, topo.normals, quad.directions)
    K, ne = levels.shape
    for k in range(K):
        for e in range(ne):
            for f in range(topo.faces_per_elem):
                if inflow[k, e, f]:
                    nbr = topo.elem_neighbor[e, f]
                    assert levels[k, nbr] < levels[k, e]


def test_levels_consistent_with_greedy(refined_topo):
    """Every greedy order must be a topological order of the level DAG: an
    element's level must be processed only after all lower levels' upwind
    deps — weaker: position in greedy order respects level monotonicity
    along dependency chains (checked via dependencies directly in the other
    test); here check level 0 elements are exactly the dependency-free ones."""
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    topo = refined_topo
    levels = planner.compute_levels(topo.elem_neighbor, topo.normals, quad.directions)
    inflow = planner.upwind_inflow(topo.elem_neighbor, topo.normals, quad.directions)
    free = ~inflow.any(axis=-1)
    np.testing.assert_array_equal(levels == 0, free)


def test_plan_grouping_and_padding(refined_topo):
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=24))
    plan = planner.build_plan(
        refined_topo.elem_neighbor, refined_topo.normals, quad.directions
    )
    # 24 in-plane directions on an axis-aligned tri mesh: few distinct DAGs
    assert plan.num_groups <= 8
    assert plan.group_of_dir.shape == (24,)
    # each group's table contains every element exactly once
    for g in range(plan.num_groups):
        elems = plan.levels[g][plan.levels[g] >= 0]
        assert sorted(elems) == list(range(refined_topo.mesh.num_elements))
    # directions in the same group have identical level assignment
    levels = planner.compute_levels(
        refined_topo.elem_neighbor, refined_topo.normals, quad.directions
    )
    for g, dirs in enumerate(plan.dirs_of_group):
        for k in dirs:
            np.testing.assert_array_equal(levels[k], plan.level_of_elem[g])


def test_cycle_detection():
    """Synthetic 3-element cycle: e0 -> e1 -> e2 -> e0 for direction +x."""
    neighbor = np.array([[1, -1], [2, -1], [0, -1]], dtype=np.int32)
    # each element's face-0 normal points so that its neighbor is upwind
    normals = np.array([[[-1.0, 0.0]], [[-1.0, 0.0]], [[-1.0, 0.0]]])
    normals = np.concatenate([normals, normals], axis=1)  # (3, 2, 2)
    dirs = np.array([[1.0, 0.0, 0.0]])
    with pytest.raises(planner.SweepCycleError):
        planner.compute_levels(neighbor, normals, dirs)
    with pytest.raises(planner.SweepCycleError):
        planner.greedy_orders(neighbor, normals, dirs)


def test_sweep_dump_golden_format(refined_topo, reference_root, tmp_path):
    quad = ang.build(ang.AngularOptions(dimension=2, polar_points=24, azimuth_points=24))
    topo2 = _topo(reference_root, 0)
    out = tmp_path / "sweep.txt"
    planner.write_sweep_orders(quad, topo2, str(out))
    golden = (
        reference_root / "output/log/sweep_dim2_np24_gauss_na24_gauss.txt"
    ).read_text()
    assert out.read_text().strip() == golden.strip()


def test_detect_lattice_hex_and_refusals():
    """Lattice detection: recovers dims/coords on canonical-face hex meshes,
    refuses triangles (wrong face count), refuses non-canonical face order
    (per-slot normals differ), and ignores periodic-masked wrap faces."""
    from pbte import mesh as pmesh
    from pbte.fem import assembly
    from pbte.sweep.planner import detect_lattice

    m = pmesh.make_cartesian_3d(5, 4, 3, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="consistent")
    # raw face order: slot normals differ per element -> refused
    assert detect_lattice(ops.sweep_neighbor, ops.normals) is None
    opsc = assembly.permute_faces(ops, assembly.canonical_face_perm(ops))
    lat = detect_lattice(opsc.sweep_neighbor, opsc.normals)
    assert lat is not None and lat.dims == (5, 4, 3)
    assert lat.coords.shape == (60, 3)
    # every coordinate triple unique and within bounds
    import numpy as np
    assert len({tuple(c) for c in lat.coords}) == 60
    # triangles: nf != 2*dim -> refused
    mt = pmesh.make_cartesian_2d(4, 4, "triangle").scaled(1e-6)
    ot = assembly.assemble(pmesh.connect(mt), order=1,
                           face_mode="consistent")
    assert detect_lattice(ot.sweep_neighbor, ot.normals) is None
    # periodic wrap masked from the sweep graph: still a lattice
    mp = pmesh.make_periodic(pmesh.make_cartesian_3d(4, 4, 4, "hex")
                             .scaled(1e-6), [0])
    op = assembly.assemble(pmesh.connect(mp), order=1,
                           face_mode="consistent")
    opc = assembly.permute_faces(op, assembly.canonical_face_perm(op))
    latp = detect_lattice(opc.sweep_neighbor, opc.normals)
    assert latp is not None and latp.dims == (4, 4, 4)
    # but the UNMASKED neighbor table has periodic cycles -> refused
    assert detect_lattice(opc.neighbor, opc.normals) is None
