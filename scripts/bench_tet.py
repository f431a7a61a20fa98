"""Tet-mesh benchmark: the legacy production shape.

Shape from the reference's production config (ref: Reference Project/config/
control/Control.yaml:13-21): cuboid 5x5x5 gmsh 6-tet mesh (750 tets), p=3
DG (D=20), 16x24 product angular quadrature (384 directions), full non-gray
2x20-band silicon spectrum. Reports element-ordinate DOF/s and the sweep
path the solver chose. The SUPERCELL merge (fem/supercell.py) turns the
6-tet mesh into a 125-cell block lattice swept by the shift-structured ring
(8 octant groups, D'=120) instead of the scan path (24 ragged signature
groups, 2.9x slot padding).

Writes bench_artifacts/tet_bench.json and prints one JSON line.

The memory policy picks bf16 state and buffer donation on its own when two
f32 state buffers exceed their share of the device's memory
(source_iteration._memory_limits); PBTE_RING_STATE_BF16=1 and
PBTE_RING_DONATE=1 force them.

Env overrides: PBTE_TET_N (default 5), PBTE_TET_ORDER (3),
PBTE_TET_POLAR (8), PBTE_TET_AZIMUTH (12), PBTE_TET_NSPEC (20),
PBTE_TET_STEPS (5), PBTE_TET_POLICY (eigen), PBTE_TET_SWEEP (auto).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main() -> None:
    import jax

    from pbte.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from pbte import mesh as pmesh
    from pbte.angular import quadrature as ang
    from pbte.fem import assembly
    from pbte.material import nongray_smrt as mat
    from pbte.solver.source_iteration import SourceIterationSolver

    n = int(os.environ.get("PBTE_TET_N", 5))
    order = int(os.environ.get("PBTE_TET_ORDER", 3))
    polar = int(os.environ.get("PBTE_TET_POLAR", 8))
    azimuth = int(os.environ.get("PBTE_TET_AZIMUTH", 12))
    nspec = int(os.environ.get("PBTE_TET_NSPEC", 20))
    steps = int(os.environ.get("PBTE_TET_STEPS", 5))
    policy = os.environ.get("PBTE_TET_POLICY", "eigen")
    sweep = os.environ.get("PBTE_TET_SWEEP", "auto")

    t0 = time.time()
    m = pmesh.make_cartesian_3d(n, n, n, "tet").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    solver = SourceIterationSolver(
        ops, quad, tables, bcs, dtype=jnp.float32, cache_policy=policy,
        sweep_mode=sweep,
    )
    ne, D, K, BS = solver.ne, solver.D, solver.K, solver.BS
    print(
        f"[bench_tet] cuboid {n}^3 tets ne={ne} p={order} D={D} K={K} "
        f"BS={BS} groups={solver.G} Km={solver.Km} "
        f"levels={solver.plan.max_levels} width={solver.plan.max_width} "
        f"sweep_mode={solver.sweep_mode} ncls={solver.ncls_ring or solver.ncls} "
        f"setup={time.time()-t0:.1f}s device={jax.devices()[0]}",
        file=sys.stderr,
    )

    u, Tc, Tv = solver.initial_state()
    t0 = time.time()
    u, Tc, Tv2, r = solver.step(u, Tc, Tv)
    jax.block_until_ready((u, Tc, Tv2, r))
    print(f"[bench_tet] compile+first step: {time.time()-t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    prev = Tv2
    for _ in range(steps):
        u, Tc, Tv2, r = solver.step(u, Tc, prev)
        prev = Tv2
    jax.block_until_ready((u, Tc, Tv2, r))
    dt = time.time() - t0
    dofs = steps * K * BS * ne * D / dt
    rec = {
        "metric": "tet_element_ordinate_dof_per_s",
        "value": dofs,
        "unit": "dof/s",
        "ms_per_step": dt / steps * 1e3,
        "sweep_mode": solver.sweep_mode,
        "groups": solver.G,
        "shape": {"ne": ne, "D": D, "K": K, "BS": BS},
        "residual": float(r),
    }
    print(
        f"[bench_tet] {steps} steps in {dt:.3f}s -> {dofs:.4g} DOF/s "
        f"({dt/steps*1e3:.1f} ms/step, path={solver.sweep_mode})",
        file=sys.stderr,
    )
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_artifacts", "tet_bench.json",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
