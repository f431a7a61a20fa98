"""AOT memory probe for the legacy tet shape (crash diagnosis).

Compiles (does NOT execute) the tet-shape step on the current backend and
prints XLA's memory analysis: argument/output/temp/peak bytes, beside the
device's memory budget. It answers whether the compiled program's peak
exceeds the device without running it (compilation allocates nothing on
the device).

Env overrides match scripts/bench_tet.py.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main() -> None:
    import jax

    from pbte.device import enable_compile_cache, memory_budget

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
    print(
        f"[probe] ne={solver.ne} D={solver.D} K={solver.K} BS={solver.BS} "
        f"G={solver.G} Km={solver.Km} ne_pad={solver.ne_pad} "
        f"W={solver.W} L={solver.plan.max_levels} "
        f"policy={solver.cache_policy} sweep={solver.sweep_mode} "
        f"seq_groups={solver._seq_groups} hoist_rhs={solver._hoist_rhs} "
        f"setup={time.time() - t0:.1f}s backend={jax.default_backend()}",
        file=sys.stderr,
    )

    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), solver.consts
    )
    # state shapes without allocating device memory
    u, Tc, Tv = jax.eval_shape(solver.initial_state)
    t0 = time.time()
    lowered = solver._step.lower(abstract, u, Tc, Tv)
    compiled = lowered.compile()
    print(f"[probe] compile: {time.time() - t0:.1f}s", file=sys.stderr)
    ma = compiled.memory_analysis()
    gb = 1024 ** 3
    print(
        "[probe] memory_analysis: "
        f"args={ma.argument_size_in_bytes / gb:.2f} GiB "
        f"out={ma.output_size_in_bytes / gb:.2f} GiB "
        f"temp={ma.temp_size_in_bytes / gb:.2f} GiB "
        f"alias={ma.alias_size_in_bytes / gb:.2f} GiB "
        f"peak(args+out+temp-alias)="
        f"{(ma.argument_size_in_bytes + ma.output_size_in_bytes + ma.temp_size_in_bytes - ma.alias_size_in_bytes) / gb:.2f} GiB; "
        f"device budget {memory_budget() / gb:.2f} GiB"
    )


if __name__ == "__main__":
    main()
