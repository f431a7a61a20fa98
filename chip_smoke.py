"""End-to-end check that the solver's main path runs on an NVIDIA GPU.

Usage, from the repository root on a machine with a GPU:

    python chip_smoke.py          # phases a-d on one card
    python chip_smoke.py --multi  # the sharded solvers on four cards
    python chip_smoke.py --ab     # flagship A/Bs: precisions and ring layouts

Default phases (one card, one JAX process):

  a. the reference's 2D demo through the CLI (`pbte.cli.main`), f64,
     mfem-parity faces, 101 iterations, against the sequential oracle;
  b. a small hex lattice ring in f64 against the oracle, iterate-exact;
  c. the flagship (hex 16^3, p=2, 64 directions x 40 bands, the problem of
     bench.py) in f32: compile step + 10 timed steps, then the same steps in
     f64 and at `highest` precision without bf16 staging, compared with f64;
  d. the reference's legacy production configuration (cuboid 5^3 6-tet,
     p=3, 384 directions x 40 bands) through the supercell ring, f32 against
     f64.

Each phase prints one line with its result, its time and its
compile-plus-first-step time; an earlier line gives the card's name and
power limit. The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script exits non-zero, without that line, when JAX finds no GPU, when a
phase fails, or when a comparison falls outside its tolerance.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = dict(nx=16, order=2, polar=4, azimuth=16, nspec=20)
FLAGSHIP_STEPS = 10
# cuboid n^3 6-tet, p=3, 16x24 = 384 directions, 2x20 bands
LEGACY = dict(n=5, order=3, polar=16, azimuth=24, nspec=20)

# Phase c/d tolerances on the relative L2 distance of Tc from the f64 run of
# the same steps. At the default precision the f32 solver rounds matmul
# operands (TF32 on an H100, bf16 in the staged lattice ring), so the
# distance is that rounding carried through the sweep: measured 3.3e-4 on
# the flagship and 8.5e-4 on the legacy tet (NVIDIA H100 80GB HBM3, 700 W),
# bounded here with a 3x margin. At `highest` only f32 storage and summation
# order remain: measured 2.2e-7, bounded with a 4.5x margin.
TOL_FLAGSHIP = 1e-3
TOL_TET = 3e-3
TOL_HIGHEST = 1e-6
# f64 against the f64 oracle: the only difference is summation order
TOL_EXACT = 1e-10
# The dir-sharded step pads Km to the shard count, which changes the matmul
# shapes and with them the summation order; at the default precision two
# such runs may differ by up to the rounding bias itself (TOL_FLAGSHIP), at
# `highest` only by f32 summation order (TOL_HIGHEST).


def rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def rel_max(a, b) -> float:
    """Largest absolute difference over the largest reference magnitude."""
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cube_problem(nx, order, polar, azimuth, nspec, geom="hex"):
    """(ops, quad, tables, bcs) of the unit-cube problem, hot top wall."""
    from pbte import mesh as pmesh
    from pbte.angular import quadrature as ang
    from pbte.fem import assembly
    from pbte.material import nongray_smrt as mat

    m = pmesh.make_cartesian_3d(nx, nx, nx, geom).scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
    return ops, quad, tables, bcs


def run_steps(solver, steps):
    """Compile step plus `steps` timed steps from the initial state.

    Returns (Tc after all steps, residuals, compile+first-step seconds,
    seconds of the timed steps)."""
    import jax
    import numpy as np

    u, Tc, Tv = solver.initial_state()
    t0 = time.perf_counter()
    u, Tc, Tv, r = solver.step(u, Tc, Tv)
    jax.block_until_ready((u, Tc, Tv, r))
    t_first = time.perf_counter() - t0
    res = [r]
    t0 = time.perf_counter()
    for _ in range(steps):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
        res.append(r)
    jax.block_until_ready((u, Tc, Tv, r))
    dt = time.perf_counter() - t0
    return (np.asarray(solver.Tc_fine(Tc)), [float(x) for x in res],
            t_first, dt)


# ---------------------------------------------------------------- phases ----


def phase_demo_cli():
    """a. The reference demo through the CLI, against the oracle."""
    import numpy as np

    from pbte import cli, mesh as pmesh
    from pbte.angular import quadrature as ang
    from pbte.config import load_run_config
    from pbte.fem import assembly
    from pbte.material import nongray_smrt
    from pbte.validation.oracle import solve_oracle

    config = os.path.join(REPO, "config", "config.yaml")
    mesh = os.path.join(REPO, "config", "mesh", "unit-square-iso.mesh")
    args = ["-c", config, "-m", mesh, "-o", "1", "--dtype", "f64",
            "--face-mode", "mfem-parity"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        rc_first = cli.main(args + ["--max-iter", "1", "--no-dumps",
                                    "--out", os.path.join(tmp, "first")])
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc_cli = cli.main(args + [
            "--max-iter", "101", "--out", os.path.join(tmp, "out"),
            "--checkpoint", ck, "--checkpoint-every", "101",
            "--check-every", "101",
        ])
        t_cli = time.perf_counter() - t0
        if rc_first != 0 or rc_cli != 0:
            raise RuntimeError(f"CLI returned {rc_first}, {rc_cli}")
        with np.load(ck) as z:
            Tc = np.array(z["Tc"])
            iters = int(z["iteration"])
    rc = load_run_config(config)
    m = pmesh.load_mesh(mesh).scaled(rc.material.ref_len)
    ops = assembly.assemble(pmesh.connect(m), order=1,
                            face_mode="mfem-parity")
    quad = ang.build(rc.angles)
    tables = nongray_smrt.build_tables(rc.material,
                                       num_spectral=rc.n_spectral)
    _, Tco, *_ = solve_oracle(ops, quad, tables, rc.bc_temps,
                              tol=rc.tolerance, max_iter=101)
    err = rel_max(Tc, Tco)
    return {
        "ok": iters == 101 and err <= TOL_EXACT,
        "line": (f"2D demo via CLI: ne={ops.num_elements} "
                 f"K={quad.num_directions} BS={tables.num_branches}x"
                 f"{tables.num_spectral} f64, {iters} iterations, "
                 f"rel max |Tc - oracle| = {err:.3e} "
                 f"(tol {TOL_EXACT:g}); compile+first (a 1-iteration CLI "
                 f"run) {t_first:.2f} s, 101-iteration CLI run {t_cli:.2f} s"),
    }


def ring_vs_oracle(nx=6, order=1, polar=2, azimuth=8, nspec=4, steps=5):
    """b. f64 lattice ring against the oracle after `steps` iterations.

    Returns (relative max error, solver sweep mode, compile+first-step s,
    seconds of the remaining steps)."""
    import jax.numpy as jnp

    from pbte.solver.source_iteration import SourceIterationSolver
    from pbte.validation.oracle import solve_oracle

    ops, quad, tables, bcs = _cube_problem(nx, order, polar, azimuth, nspec)
    solver = SourceIterationSolver(ops, quad, tables, bcs,
                                   dtype=jnp.float64, sweep_mode="ring")
    Tc, _, t_first, dt = run_steps(solver, steps - 1)
    _, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0,
                              max_iter=steps)
    return rel_max(Tc, Tco), solver.sweep_mode, t_first, dt


def phase_ring_oracle():
    err, mode, t_first, dt = ring_vs_oracle()
    return {
        "ok": mode == "ring" and err <= TOL_EXACT,
        "line": (f"hex 6^3 p=1 ring f64 vs oracle after 5 steps: "
                 f"sweep_mode={mode}, rel max err {err:.3e} "
                 f"(tol {TOL_EXACT:g}); compile+first {t_first:.2f} s, "
                 f"4 steps {dt:.3f} s"),
    }


def _flagship(dtype, **kw):
    from __graft_entry__ import _build_problem

    return _build_problem(**FLAGSHIP, dtype=dtype, geom="hex", dim=3,
                          cache_policy="eigen", **kw)


def _with_env(env, fn):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _flagship_run(dtype, env=None, **kw):
    """Build the flagship under `env`, run it, free it. Returns a record."""
    def go():
        t0 = time.perf_counter()
        s = _flagship(dtype, **kw)
        t_setup = time.perf_counter() - t0
        info = dict(
            sweep_mode=s.sweep_mode, windowed=s._ring_windowed,
            stage_bf16=s._ring_stage_bf16, state_bf16=s._ring_state_bf16,
            dof=s.K * s.BS * s.ne * s.D,
        )
        Tc, res, t_first, dt = run_steps(s, FLAGSHIP_STEPS)
        return dict(info, Tc=Tc, res=res, t_setup=t_setup, t_first=t_first,
                    ms=dt / FLAGSHIP_STEPS * 1e3,
                    dofs=FLAGSHIP_STEPS * info["dof"] / dt)

    rec = _with_env(env or {}, go)
    gc.collect()
    return rec


def _falling(res):
    import numpy as np

    return bool(np.all(np.isfinite(res)) and res[-1] < res[0])


def _fmt_run(name, r):
    return (f"{name}: {r['ms']:.3f} ms/step, {r['dofs']:.4g} "
            f"element-ordinate DOF/s, residual {r['res'][0]:.3e} -> "
            f"{r['res'][-1]:.3e}, setup {r['t_setup']:.1f} s, "
            f"compile+first {r['t_first']:.1f} s")


def phase_flagship(variants=()):
    """c. The flagship in f32 and f64; f32 variants compared with f64.

    `variants` adds (name, env, solver kwargs, tolerance or None) runs."""
    import jax.numpy as jnp

    lines = []
    ok = True
    f32 = _flagship_run(jnp.float32)
    ok &= f32["sweep_mode"] == "ring" and _falling(f32["res"])
    lines.append(_fmt_run(
        f"flagship hex 16^3 p=2 K=64 BS=40 f32 ({f32['sweep_mode']}, windowed="
        f"{f32['windowed']}, bf16 staging={f32['stage_bf16']})", f32))
    f64 = _flagship_run(jnp.float64)
    ok &= _falling(f64["res"])
    lines.append(_fmt_run("flagship f64", f64))
    ref = f64["Tc"]
    d = rel_l2(f32["Tc"], ref)
    ok &= d <= TOL_FLAGSHIP
    lines.append(f"flagship f32 default precision vs f64: rel L2 of Tc "
                 f"{d:.3e} (tol {TOL_FLAGSHIP:g})")
    runs = [("highest, PBTE_RING_BF16=0", {"PBTE_RING_BF16": "0"},
             {"matmul_precision": "highest"}, TOL_HIGHEST)]
    runs += list(variants)
    for name, env, kw, tol in runs:
        r = _flagship_run(jnp.float32, env=env, **kw)
        d = rel_l2(r["Tc"], ref)
        good = _falling(r["res"]) and (tol is None or d <= tol)
        ok &= good
        lines.append(_fmt_run(f"flagship f32 {name}", r))
        lines.append(
            f"flagship f32 {name} vs f64: rel L2 of Tc {d:.3e}"
            + (f" (tol {tol:g})" if tol is not None else " (reported)")
        )
    return {"ok": bool(ok), "line": "\n".join(lines)}


def legacy_tet_solver(dtype, n, order, polar, azimuth, nspec):
    """The reference's legacy production problem (cuboid n^3 6-tet)."""
    from pbte.solver.source_iteration import SourceIterationSolver

    ops, quad, tables, bcs = _cube_problem(n, order, polar, azimuth, nspec,
                                           geom="tet")
    s = SourceIterationSolver(ops, quad, tables, bcs, dtype=dtype)
    return s, ops.num_elements * ops.ndof


def phase_legacy_tet(steps=5):
    """d. Legacy production tet through the supercell ring, f32 vs f64."""
    import jax.numpy as jnp

    out = {}
    lines = []
    for name, dt_ in (("f32", jnp.float32), ("f64", jnp.float64)):
        t0 = time.perf_counter()
        s, fine_dof = legacy_tet_solver(dt_, **LEGACY)
        t_setup = time.perf_counter() - t0
        state = "bf16" if s._ring_state_bf16 else name
        Tc, res, t_first, dt = run_steps(s, steps - 1)
        out[name] = Tc
        ok_run = (s._super is not None and s.sweep_mode == "ring"
                  and _falling(res))
        lines.append(
            f"legacy tet 5^3 p=3 K={s.K} BS={s.BS} {name}: supercell="
            f"{s._super is not None} sweep_mode={s.sweep_mode} state dtype "
            f"chosen by the memory policy: {state}; "
            f"{dt / (steps - 1) * 1e3:.3f} ms/step, "
            f"{(steps - 1) * s.K * s.BS * fine_dof / dt:.4g} element-ordinate "
            f"DOF/s, residual {res[0]:.3e} -> {res[-1]:.3e}, setup "
            f"{t_setup:.1f} s, compile+first {t_first:.1f} s"
        )
        out[name + "_ok"] = ok_run
        del s
        gc.collect()
    d = rel_l2(out["f32"], out["f64"])
    lines.append(f"legacy tet f32 default precision vs f64: rel L2 of Tc "
                 f"{d:.3e} (tol {TOL_TET:g})")
    return {"ok": bool(out["f32_ok"] and out["f64_ok"] and d <= TOL_TET),
            "line": "\n".join(lines)}


# ------------------------------------------------------------ four cards ----


def phase_multi_dir():
    """The flagship with dir sharding over four cards vs one card, 2 steps,
    at the default precision and at `highest` without bf16 staging."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("dir",))
    shard = {"dir_sharding": NamedSharding(mesh, P("dir"))}
    lines = []
    ok = True
    for prec, env, kw, tol in (
        ("default", {}, {}, TOL_FLAGSHIP),
        ("highest", {"PBTE_RING_BF16": "0"},
         {"matmul_precision": "highest"}, TOL_HIGHEST),
    ):
        out = {}
        for name, skw in (("1 card", {}), ("4 cards", shard)):
            def go():
                s = _flagship(jnp.float32, **kw, **skw)
                u, Tc, Tv = s.initial_state()
                t0 = time.perf_counter()
                u, Tc, Tv, r = s.step(u, Tc, Tv)
                jax.block_until_ready((u, Tc, Tv, r))
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
                u, Tc, Tv, r = s.step(u, Tc, Tv)
                jax.block_until_ready((u, Tc, Tv, r))
                dt = time.perf_counter() - t0
                return np.asarray(s.Tc_fine(Tc)), s.Km, t_first, dt

            Tc, km, t_first, dt = _with_env(env, go)
            gc.collect()
            out[name] = Tc
            lines.append(f"  {prec}, {name}: Km={km}, compile+first "
                         f"{t_first:.1f} s, second step {dt * 1e3:.3f} ms")
        d = rel_l2(out["4 cards"], out["1 card"])
        ok &= d <= tol
        lines.insert(len(lines) - 2,
                     f"flagship {prec}: dir-sharded over 4 cards vs 1 card "
                     f"after 2 steps, rel L2 of Tc {d:.3e} (tol {tol:g})")
    return {"ok": bool(ok), "line": "\n".join(lines)}


def slab_vs_lagged_oracle(device_mesh, nx=8, polar=2, azimuth=4, nspec=2,
                          steps=2):
    """SlabLatticeSolver against the sequential lagged-interface oracle.

    The hex nx^3 p=1 problem with isothermal x walls, diffuse y walls and
    specular z walls. Returns the relative max error and the solver."""
    import jax.numpy as jnp
    import numpy as np

    from pbte.parallel.slab import SlabLatticeSolver
    from pbte.validation.oracle import solve_oracle

    ops, quad, tables, _ = _cube_problem(nx, 1, polar, azimuth, nspec)
    bcs = {5: -0.5, 3: 0.5}
    sl = SlabLatticeSolver(
        ops, quad, tables, bcs, device_mesh=device_mesh, dtype=jnp.float64,
        diffuse_bcs=[1, 2], specular_bcs=[4, 6],
    )
    r = sl.solve(tol=0, max_iter=steps, verbose=False)
    part = sl.element_partition.astype(np.int64)
    _, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0,
                              max_iter=steps, part=part,
                              diffuse=[1, 2], specular=[4, 6])
    return rel_max(r.Tc_global(), Tco), sl


def phase_multi_slab():
    """SlabLatticeSolver on a (1, 4) ("dir", "space") mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from pbte.parallel.slab import SlabLatticeSolver

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                axis_names=("dir", "space"))
    t0 = time.perf_counter()
    err, sl = slab_vs_lagged_oracle(mesh)
    t_small = time.perf_counter() - t0
    lines = [f"slab lattice (1, 4) hex 8^3 p=1 f64 vs lagged oracle: rel max "
             f"err {err:.3e} (tol {TOL_EXACT:g}), slabs={sl.P}; "
             f"{t_small:.1f} s"]
    ok = err <= TOL_EXACT
    del sl
    gc.collect()

    ops, quad, tables, bcs = _cube_problem(
        FLAGSHIP["nx"], FLAGSHIP["order"], FLAGSHIP["polar"],
        FLAGSHIP["azimuth"], FLAGSHIP["nspec"])
    t0 = time.perf_counter()
    sl = SlabLatticeSolver(ops, quad, tables, bcs, device_mesh=mesh,
                           dtype=jnp.float32)
    t_setup = time.perf_counter() - t0
    u, Tc, Tv = sl.initial_state()
    res = []
    t0 = time.perf_counter()
    u, Tc, Tv, r = sl.step(u, Tc, Tv)
    jax.block_until_ready((u, Tc, Tv, r))
    t_first = time.perf_counter() - t0
    res.append(r)
    t0 = time.perf_counter()
    for _ in range(2):
        u, Tc, Tv, r = sl.step(u, Tc, Tv)
        res.append(r)
    jax.block_until_ready((u, Tc, Tv, r))
    dt = time.perf_counter() - t0
    res = [float(x) for x in res]
    halo = sl.G * sl.Km * sl.D * sl.BS * sl.W * 4
    ok &= _falling(res)
    lines.append(
        f"slab lattice (1, 4) flagship f32, 3 steps: slabs={sl.P} "
        f"W={sl.W} L={sl.L}, halo {halo} bytes per shard per iteration "
        f"(one exit layer, f32), residual {res[0]:.3e} -> {res[-1]:.3e}, "
        f"setup {t_setup:.1f} s, compile+first {t_first:.1f} s, "
        f"{dt / 2 * 1e3:.3f} ms/step"
    )
    return {"ok": bool(ok), "line": "\n".join(lines)}


# ------------------------------------------------------------------ main ----


def _ab_variants():
    """Flagship A/Bs: the other precisions and the ring's layout options."""
    return [
        ("high", {}, {"matmul_precision": "high"}, None),
        ("selective", {}, {"matmul_precision": "selective"}, None),
        ("default, PBTE_RING_BF16=0 (no bf16 staging)",
         {"PBTE_RING_BF16": "0"}, {}, None),
        ("default, PBTE_RING_STATE_BF16=1 (bf16 state)",
         {"PBTE_RING_STATE_BF16": "1"}, {}, None),
        ("default, PBTE_RING_WINDOWS=0 (no hull windows)",
         {"PBTE_RING_WINDOWS": "0"}, {}, None),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded solvers")
    ap.add_argument("--ab", action="store_true",
                    help="run only the flagship phase, with its A/Bs")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r}); nothing was run", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    try:
        from pbte.device import card, enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the pbte package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    enable_compile_cache()

    need = 4 if args.multi else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2
    if args.multi:
        phases = [("multi dir sharding", phase_multi_dir),
                  ("multi slab lattice", phase_multi_slab)]
    elif args.ab:
        phases = [("c flagship A/B", lambda: phase_flagship(_ab_variants()))]
    else:
        phases = [("a demo CLI", phase_demo_cli),
                  ("b ring vs oracle", phase_ring_oracle),
                  ("c flagship", phase_flagship),
                  ("d legacy tet", phase_legacy_tet)]

    ok = True
    try:
        line = card()
        print(f"card: {line}", flush=True)
        ok = bool(line)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"card: nvidia-smi failed: {e}", flush=True)
        ok = False
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            r = fn()
        except Exception:
            traceback.print_exc()
            r = {"ok": False, "line": "raised (traceback on stderr)"}
        ok &= bool(r["ok"])
        status = "PASS" if r["ok"] else "FAIL"
        print(f"[{name}] {status} ({time.perf_counter() - t0:.1f} s)\n"
              f"  " + r["line"].replace("\n", "\n  "), flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
