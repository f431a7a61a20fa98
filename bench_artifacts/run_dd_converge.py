"""Converged production-scale domain-decomposition run.

Runs the unstructured spatial DD solver (SpatialShardedSolver, class-batched
factors, multilevel partition) on the 24^3 6-tet mesh (82,944 elements) over
the 8-virtual-device CPU mesh ("dir" x "space" = 2 x 4), to convergence (or
--max-iter), and commits the FULL residual trace so a reviewer can see the
block-Jacobi outer loop converge at production partition counts — not just
stay finite for 3 steps (tests/test_parallel.py:474 checks 3 steps only).

Residual semantics match the reference root-computed relative Tv change
(reference/DGSolver/PBTE_NonGraySMRT_MPI.cpp:268-315), here a psum so every
shard agrees.

Usage (from repo root):
    python bench_artifacts/run_dd_converge.py [--n 24] [--max-iter 200]
        [--tol 1e-7] [--out bench_artifacts/dd_converge_24cube.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache")
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--polar", type=int, default=2)
    ap.add_argument("--azimuth", type=int, default=4)
    ap.add_argument("--nspec", type=int, default=2)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument(
        "--max-seconds",
        type=float,
        default=0,
        help="wall-clock budget for the iteration loop (0 = unlimited); "
        "the artifact is written either way",
    )
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "dd_converge_24cube.json",
        ),
    )
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from pbte import mesh as pmesh
    from pbte.angular import quadrature as ang
    from pbte.fem import assembly
    from pbte.material import nongray_smrt as mat
    from pbte.parallel.spatial import SpatialShardedSolver
    from jax.sharding import Mesh

    t0 = time.time()
    n = args.n
    m = pmesh.make_cartesian_3d(n, n, n, "tet").scaled(1e-6)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=args.order, face_mode="consistent")
    quad = ang.build(
        ang.AngularOptions(
            dimension=3,
            polar_points=args.polar,
            azimuth_points=args.azimuth,
        )
    )
    tables = mat.build_tables(mat.SILICON, num_spectral=args.nspec)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh_dev = Mesh(devs, axis_names=("dir", "space"))
    solver = SpatialShardedSolver(
        ops,
        quad,
        tables,
        bcs,
        mesh_dev,
        topo=topo,
        partition_method="multilevel",
    )
    setup_s = time.time() - t0
    ncls = (
        int(solver._spatial_cls.max()) + 1
        if solver._spatial_cls is not None
        else None
    )
    print(
        f"[dd] {n}^3 tets ne={solver.ne} D={solver.D} K={solver.K} "
        f"BS={solver.BS} parts={solver.pplan.nparts} "
        f"balance={solver.pplan.load_balance():.3f} classes={ncls} "
        f"setup={setup_s:.1f}s",
        flush=True,
    )

    u, Tc, Tv = solver.initial_state()
    residuals = []
    iter_times = []
    t_solve0 = time.time()
    converged_at = None
    for it in range(args.max_iter):
        t1 = time.time()
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
        r = float(r)
        iter_times.append(time.time() - t1)
        residuals.append(r)
        if it < 5 or (it + 1) % 10 == 0:
            print(
                f"[dd] iter {it + 1:4d} residual {r:.6e} "
                f"({iter_times[-1]:.1f}s)",
                flush=True,
            )
        if not np.isfinite(r):
            print("[dd] NON-FINITE residual — aborting", flush=True)
            break
        if r < args.tol:
            converged_at = it + 1
            print(f"[dd] converged at iter {converged_at}", flush=True)
            break
        if args.max_seconds and time.time() - t_solve0 > args.max_seconds:
            print(
                f"[dd] wall-clock budget {args.max_seconds}s reached "
                f"after {it + 1} iters",
                flush=True,
            )
            break
    solve_s = time.time() - t_solve0

    rs = np.array(residuals)
    # monotone tail: over the last half of the trace, every residual must be
    # below the max of the preceding 5 (allows tiny plateaus, forbids growth)
    tail = rs[len(rs) // 2 :]
    tail_monotone = all(
        tail[i] <= tail[max(0, i - 5) : i].max() * (1 + 1e-12)
        for i in range(1, len(tail))
    )
    # geometric decay rate over the tail
    rate = float((tail[-1] / tail[0]) ** (1.0 / max(1, len(tail) - 1)))

    Tc_g = solver.gather_Tc(Tc)
    out = {
        "metric": "dd_converge_24cube",
        "mesh": f"{n}^3 6-tet (ne={solver.ne})",
        "order": args.order,
        "D": solver.D,
        "K": solver.K,
        "BS": solver.BS,
        "device_mesh": "2 dir x 4 space (8 virtual CPU devices)",
        "partition": {
            "method": "multilevel",
            "nparts": solver.pplan.nparts,
            "load_balance": round(solver.pplan.load_balance(), 4),
        },
        "tol": args.tol,
        "iterations_run": len(residuals),
        "converged_at": converged_at,
        "final_residual": residuals[-1] if residuals else None,
        "residual_trace": [float(f"{r:.6e}") for r in residuals],
        "tail_monotone": bool(tail_monotone),
        "tail_geometric_rate_per_iter": round(rate, 6),
        "field_finite": bool(np.isfinite(Tc_g).all()),
        "field_abs_max": float(np.abs(Tc_g).max()),
        "setup_s": round(setup_s, 1),
        "solve_s": round(solve_s, 1),
        "s_per_iter_mean": round(float(np.mean(iter_times)), 2),
        "note": (
            "block-Jacobi outer loop (lagged cross-partition upwind data, "
            "halo via ppermute once per outer iteration) at production "
            "partition counts; residual is the psum'd global relative Tv "
            "change, matching reference root semantics "
            "(PBTE_NonGraySMRT_MPI.cpp:268-315)"
        ),
        "cmd": "python bench_artifacts/run_dd_converge.py",
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[dd] wrote {args.out}", flush=True)
    ok = tail_monotone and (converged_at is not None or rs[-1] < rs[0] * 1e-2)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
