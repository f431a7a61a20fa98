"""Convergence-to-tolerance demo on the flagship problem.

Runs the hex 16^3 p=2 flagship (64 directions x 40 bands) source iteration
to a target tolerance, recording the full residual curve, iterations and
wall time, and writes bench_artifacts/converge_flagship.json. This is the
"source iterations to 1e-8" half of the north-star metric (ROADMAP.md).

Env:
  PBTE_CONV_TOL        target tolerance (default 1e-7)
  PBTE_CONV_PROBE      extra probe tolerance to report crossing (default 1e-8)
  PBTE_CONV_MAXIT      iteration cap (default 4000)
  PBTE_CONV_PRECISION  "default" | "highest" matmul precision (default both
                       tried only if the default plateaus above PROBE)
  PBTE_CONV_ACCEL      "bicgstab" to Krylov-accelerate (solver/accel.py);
                       artifacts get an _bicgstab suffix
  PBTE_CONV_NX/ORDER/POLAR/AZIMUTH/NSPEC  shape overrides
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def build(dtype, matmul_precision):
    import jax.numpy as jnp

    from pbte import mesh as pmesh
    from pbte.angular import quadrature as ang
    from pbte.fem import assembly
    from pbte.material import nongray_smrt as mat
    from pbte.solver.source_iteration import SourceIterationSolver

    nx = int(os.environ.get("PBTE_CONV_NX", 16))
    order = int(os.environ.get("PBTE_CONV_ORDER", 2))
    polar = int(os.environ.get("PBTE_CONV_POLAR", 4))
    azimuth = int(os.environ.get("PBTE_CONV_AZIMUTH", 16))
    nspec = int(os.environ.get("PBTE_CONV_NSPEC", 20))
    m = pmesh.make_cartesian_3d(nx, nx, nx, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    return SourceIterationSolver(
        ops, quad, tables, bcs, dtype=dtype, cache_policy="eigen",
        matmul_precision=matmul_precision,
    )


def run_to_tol(solver, tol, probe, max_iter, check_every=10, polish=0):
    curve = []
    t0 = time.time()
    probe_hit = None

    def cb(it, res):
        nonlocal probe_hit
        curve.append([it, res])
        if probe_hit is None and res < probe:
            probe_hit = it

    accel = os.environ.get("PBTE_CONV_ACCEL", "") or None
    res = solver.solve(tol=tol, max_iter=max_iter, verbose=True,
                       check_every=check_every, callback=cb,
                       accelerate=accel, polish_iters=polish,
                       polish_extrapolate=os.environ.get(
                           "PBTE_CONV_POLISH_EXTRAP", "") == "1")
    wall = time.time() - t0
    return res, curve, probe_hit, wall


def main() -> None:
    import jax

    from pbte.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    tol = float(os.environ.get("PBTE_CONV_TOL", 1e-7))
    probe = float(os.environ.get("PBTE_CONV_PROBE", 1e-8))
    max_iter = int(os.environ.get("PBTE_CONV_MAXIT", 4000))
    precision = os.environ.get("PBTE_CONV_PRECISION", "default")

    out = {"tol": tol, "probe": probe, "runs": []}
    prec_arg = None if precision == "default" else precision
    solver = build(jnp.float32, prec_arg)
    print(f"[converge] f32 ring ({precision}): sweep={solver.sweep_mode} "
          f"lattice={getattr(solver, '_ring_lattice', False)}",
          file=sys.stderr)
    polish = int(os.environ.get("PBTE_CONV_POLISH", 0))
    res, curve, probe_hit, wall = run_to_tol(
        solver, probe, probe, max_iter, polish=polish
    )
    tol_hit = next((it for it, r in curve if r < tol), None)
    accel = os.environ.get("PBTE_CONV_ACCEL", "")
    rec = {
        "dtype": "f32", "precision": precision, "accelerate": accel or None,
        "final_residual": res.residual, "iterations": res.iterations,
        "wall_s": wall, "iters_to_tol": tol_hit,
        "iters_to_probe": probe_hit,
        "curve": curve[:: max(1, len(curve) // 200)],
        "min_residual": min(r for _, r in curve),
    }
    out["runs"].append(rec)
    print(f"[converge] f32/{precision}: res={res.residual:.3e} after "
          f"{res.iterations} iters ({wall:.1f}s); tol {tol:g} at iter "
          f"{tol_hit}, probe {probe:g} at iter {probe_hit}", file=sys.stderr)
    Tc_f32 = np.asarray(res.Tc)

    art = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_artifacts", "converge_flagship.json",
    )
    os.makedirs(os.path.dirname(art), exist_ok=True)
    suffix = precision + (f"_{accel}" if accel else "")
    if polish:
        suffix += f"_polish{polish}"
    nx_env = int(os.environ.get("PBTE_CONV_NX", 16))
    if nx_env != 16:
        suffix += f"_nx{nx_env}"  # never overwrite the flagship artifacts
    # field snapshot for cross-run error comparison
    npz = art.replace(".json", f"_{suffix}.npz")
    np.savez_compressed(npz, Tc=Tc_f32)
    out["field_file"] = npz
    with open(art if suffix == "default" else
              art.replace(".json", f"_{suffix}.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in rec.items() if k != "curve"}))


if __name__ == "__main__":
    main()
