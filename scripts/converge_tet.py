"""Full-resolution legacy tet production run.

The reference's legacy production configuration (ref: Reference Project/
config/control/Control.yaml:13-21 + src/PhononBTE/PhononBTE.cpp:60):
cuboid 5x5x5 6-tet gmsh mesh (750 tets), p=3 DG (D=20), 16x24 = 384
directions, 2x20 silicon bands — run on one device at the FULL angular
resolution to convergence, via the supercell ring sweep (fem/supercell.py).

Writes bench_artifacts/tet_fullres.json with per-phase timings, the
residual trace, and element-ordinate DOF/s.

Env: PBTE_TETC_N (5), PBTE_TETC_ORDER (3), PBTE_TETC_POLAR (16),
PBTE_TETC_AZIMUTH (24), PBTE_TETC_NSPEC (20), PBTE_TETC_TOL (1e-7),
PBTE_TETC_MAXIT (3000), PBTE_TETC_STATE_BF16 (0), PBTE_TETC_DONATE (0).
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
    # bf16 state and forced donation stay available as overrides for A/B;
    # the memory policy picks them on its own when f32 state does not fit
    if os.environ.get("PBTE_TETC_STATE_BF16", "0") == "1":
        os.environ.setdefault("PBTE_RING_STATE_BF16", "1")
    if os.environ.get("PBTE_TETC_DONATE", "0") == "1":
        os.environ.setdefault("PBTE_RING_DONATE", "1")
    import jax

    from pbte.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from pbte import mesh as pmesh
    from pbte.angular import quadrature as ang
    from pbte.fem import assembly
    from pbte.material import nongray_smrt as mat
    from pbte.solver.source_iteration import SourceIterationSolver

    n = int(os.environ.get("PBTE_TETC_N", 5))
    order = int(os.environ.get("PBTE_TETC_ORDER", 3))
    polar = int(os.environ.get("PBTE_TETC_POLAR", 16))
    azimuth = int(os.environ.get("PBTE_TETC_AZIMUTH", 24))
    nspec = int(os.environ.get("PBTE_TETC_NSPEC", 20))
    tol = float(os.environ.get("PBTE_TETC_TOL", 1e-7))
    max_iter = int(os.environ.get("PBTE_TETC_MAXIT", 3000))

    t0 = time.time()
    m = pmesh.make_cartesian_3d(n, n, n, "tet").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    solver = SourceIterationSolver(
        ops, quad, tables, bcs, dtype=jnp.float32,
    )
    t_setup = time.time() - t0
    sup = solver._super
    print(
        f"[converge_tet] cuboid {n}^3 ne={n**3*6} p={order} "
        f"K={solver.K} BS={solver.BS} path={solver.sweep_mode} "
        f"super={'yes' if sup else 'no'} G={solver.G} Km={solver.Km} "
        f"L={solver.L} W={solver.W} setup={t_setup:.1f}s "
        f"device={jax.devices()[0]}",
        file=sys.stderr,
    )

    u, Tc, Tv = solver.initial_state()
    t0 = time.time()
    u, Tc, Tv2, r = solver.step(u, Tc, Tv)
    jax.block_until_ready((u, Tc, Tv2, r))
    t_compile = time.time() - t0
    print(f"[converge_tet] compile+first step: {t_compile:.1f}s",
          file=sys.stderr)

    trace = []
    t0 = time.time()
    prev = Tv2
    it = 1
    res = float("inf")
    while it < max_iter:
        u, Tc, Tv2, r = solver.step(u, Tc, prev)
        prev = Tv2
        it += 1
        if it % 20 == 0 or it == max_iter:
            res = float(r)
            trace.append((it, res))
            if it % 100 == 0:
                print(f"[converge_tet] iter {it} residual {res:.4e}",
                      file=sys.stderr)
            if res < tol:
                break
    dt = time.time() - t0
    ne_f = n ** 3 * 6
    D_f = ops.ndof
    dofs = (it - 1) * solver.K * solver.BS * ne_f * D_f / dt
    rec = {
        "metric": "tet_fullres_element_ordinate_dof_per_s",
        "value": dofs,
        "unit": "dof/s",
        "ms_per_step": dt / (it - 1) * 1e3,
        "iterations": it,
        "residual": res,
        "tol": tol,
        "converged": res < tol,
        "setup_s": t_setup,
        "compile_first_step_s": t_compile,
        "solve_s": dt,
        "path": solver.sweep_mode,
        "supercell": sup is not None,
        "state_bf16": solver._ring_state_bf16,
        "shape": {
            "ne": ne_f, "D": D_f, "K": solver.K, "BS": solver.BS,
            "G": solver.G, "Km": solver.Km, "L": solver.L, "W": solver.W,
        },
        "residual_trace": trace[-50:],
    }
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_artifacts", "tet_fullres.json",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(
        f"[converge_tet] {it} iters to residual {res:.3e} in {dt:.1f}s "
        f"-> {dofs:.4g} DOF/s ({dt/(it-1)*1e3:.1f} ms/step)",
        file=sys.stderr,
    )
    print(json.dumps({k: rec[k] for k in (
        "metric", "value", "unit", "ms_per_step", "iterations",
        "residual", "converged")}))


if __name__ == "__main__":
    main()
