"""Iterative refinement on the flagship: the 1e-8 field north star.

The f32 fixed point carries a converged bias from the f32 rounding of the
step's own OUTPUTS and, at the default precision, from rounded matmul
operands; compensated (double-f32) state was tested and refuted — widening
the state cannot see output rounding. What does work (method-level proof:
tests/test_accel.py::test_refined_solve_reaches_1e8) is classic ITERATIVE
REFINEMENT with the correction solved AT x-SCALE:

  repeat:
    d  = F64(x) - x          # ONE step of an exact float64 twin (CPU)
    if ||d|| / ((1 - rho) ||x||) <= target: stop   # certified a-posteriori
    solve (I - A) w = s*d with the f32 device solver  # s = 2^round(lg |x|/|d|)
    x += w / s               # combine in float64 on host

Per-round error contraction is the f32 solver's own relative bias (the
correction inherits it at x-scale), so a tier with a small bias needs few
rounds from any f32 base point. The certification bound is the standard
fixed-point a-posteriori estimate ||x - x*|| <= ||F(x) - x|| / (1 - rho)
with rho measured from the base solve's residual decay.

Because the contraction is set by the CORRECTION solver's tier, the BASE
solve can run at the cheap default tier (--base-tier default): starting
the refinement from the default-tier point costs at most one extra round
while the base solve itself runs faster. --inner krylov replaces the plain
fixed-point correction solve with BiCGStab (the defect is spilled to host);
its Krylov vectors sit beside the step's own state-sized temporaries, so it
needs more device memory than --inner plain. Each round's BiCGStab
stagnation at the f32 floor IS the per-round contraction refinement needs,
so the stagnation that limits a direct deep-tolerance f32 Krylov solve is
harmless inside refinement.

The float64 twin runs in a persistent CPU subprocess (JAX_PLATFORMS=cpu,
x64): an IDENTICAL SourceIterationSolver build (same mesh/quadrature/
spectrum/ring plan — the plan depends only on the problem + PBTE_* env, not
on dtype/platform), exchanging the raw state-tree leaves through npz files.
Leaf shapes are asserted equal on both sides. Requires exact-dtype f32
state: refuses PBTE_RING_STATE_BF16 (bf16 state leaves).

Reference anchor: the fields being certified are the reference's converged
Tc/Tv (src/MacroscopicQuantities.cpp:104-157); the f64 twin is the same
step map the golden f64 CPU tests pin byte-identically.

Usage (from repo root, on the accelerator):
    python scripts/converge_flagship_refined.py [--nx 16] [--tier high]
        [--target 1e-8] [--rounds 4]
        [--out bench_artifacts/converge_flagship_refined.json]
Worker mode (internal): ... --worker
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache")
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")


def _build(nx, tier, dtype_name):
    import jax.numpy as jnp

    from __graft_entry__ import _build_problem

    kw = {}
    if tier and dtype_name == "float32":
        kw["matmul_precision"] = tier
    return _build_problem(
        nx=nx, order=2, polar=4, azimuth=16, nspec=20,
        dtype=jnp.float64 if dtype_name == "float64" else jnp.float32,
        geom="hex", dim=3, cache_policy="eigen", **kw,
    )


def _flatten(tree):
    import jax

    return jax.tree_util.tree_flatten(tree)


def worker_main(args) -> int:
    """Persistent float64 twin: lines 'STEP <in.npz> <out.npz>' on stdin;
    replies 'READY', then 'DONE <dnorm>' / 'ERR <msg>' per task."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    t0 = time.time()
    solver = _build(args.nx, None, "float64")
    u0, Tc0, Tv0 = solver.initial_state()
    leaves0, treedef = _flatten((u0, Tc0))
    shapes = [tuple(l.shape) for l in leaves0]
    print(f"READY setup={time.time() - t0:.1f}s nleaves={len(leaves0)}",
          flush=True)
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "QUIT":
            break
        try:
            _, fin, fout = parts
            with np.load(fin) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(shapes))]
            got = [tuple(l.shape) for l in leaves]
            assert got == shapes, f"tree shape mismatch: {got} vs {shapes}"
            x = jax.tree_util.tree_unflatten(
                treedef,
                [np.asarray(l, dtype=np.float64) for l in leaves],
            )
            t1 = time.time()
            u_p, Tc_p, _, _ = solver.step(x[0], x[1], Tv0)
            out_leaves, _ = _flatten((u_p, Tc_p))
            out_leaves = [np.asarray(l, dtype=np.float64)
                          for l in out_leaves]
            np.savez(fout, **{f"leaf_{i}": l
                              for i, l in enumerate(out_leaves)})
            print(f"DONE step={time.time() - t1:.1f}s", flush=True)
        except Exception as e:  # report, keep serving
            print(f"ERR {type(e).__name__}: {e}"[:500].replace("\n", " "),
                  flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=16)
    ap.add_argument("--tier", default="high",
                    help="matmul precision tier of the f32 solver "
                         "(default|high|highest|selective)")
    ap.add_argument("--base-tier", default="",
                    help="tier for the BASE solve only (defaults to "
                         "--tier). 'default' runs the base ~3x faster; "
                         "the per-round contraction is set by the "
                         "CORRECTION tier, so this costs at most one "
                         "extra round")
    ap.add_argument("--platform", default="",
                    help="force a jax platform (e.g. cpu) for smoke runs")
    ap.add_argument("--target", type=float, default=1e-8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--base-tol", type=float, default=1e-8)
    ap.add_argument("--base-max-iter", type=int, default=2500)
    ap.add_argument("--inner-tol", type=float, default=1e-4)
    ap.add_argument("--inner-max-iter", type=int, default=1500)
    ap.add_argument("--inner", default="plain", choices=("plain", "krylov"),
                    help="correction solver: plain fixed point (least "
                         "device memory: 2 extra state trees) or bicgstab "
                         "(fewer step applications, ~8 state trees)")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--save-state", default="",
                    help="npz path for the refined f64 state leaves "
                         "(outside the repo; ~2.3 GB at nx=16)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "bench_artifacts", "converge_flagship_refined.json"))
    args = ap.parse_args()
    if args.worker:
        return worker_main(args)

    for var in ("PBTE_RING_STATE_BF16",):
        if os.environ.get(var, "0") not in ("", "0"):
            raise SystemExit(f"refined run needs exact-dtype f32 state; "
                             f"unset {var}")

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from pbte.solver import accel

    # ---- persistent f64 twin (CPU subprocess) ---------------------------
    wdir = tempfile.mkdtemp(prefix="pbte_refined_")
    wlog = open(os.path.join(wdir, "worker.log"), "w")
    worker = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--nx", str(args.nx)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=wlog,
        text=True, bufsize=1, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1"},
    )

    def worker_line():
        ln = worker.stdout.readline()
        if not ln:
            raise RuntimeError("f64 worker died — see worker.log")
        print(f"[refined] worker: {ln.strip()}", flush=True)
        if ln.startswith("ERR"):
            raise RuntimeError(ln.strip())
        return ln

    # ---- f32 base solve on the device ------------------------------------------
    base_tier = args.base_tier or args.tier
    t0 = time.time()
    solver = _build(args.nx, base_tier, "float32")
    print(f"[refined] f32 solver ({base_tier}) setup {time.time()-t0:.1f}s "
          f"ne={solver.ne} D={solver.D} K={solver.K} BS={solver.BS}",
          flush=True)
    res_hist = []
    t0 = time.time()
    res = solver.solve(tol=args.base_tol, max_iter=args.base_max_iter,
                       verbose=True, check_every=20,
                       callback=lambda it, r: res_hist.append((it, r)))
    base_s = time.time() - t0
    print(f"[refined] base solve: {res.iterations} iters, residual "
          f"{res.residual:.3e}, {base_s:.1f}s", flush=True)

    # rho = contraction factor of F, estimated from the residual decay
    # BEFORE the precision noise floor (on the floor the residual
    # fluctuates, rate -> 1, and the bound would be uselessly inflated).
    # Pre-floor, per-window rates approach rho from below as the slowest
    # mode dominates -> take the MAX rate over windows safely above the
    # floor (conservative upper estimate of rho).
    hist = [(it, r) for it, r in res_hist if r > 0]
    floor = min((r for _, r in hist), default=1.0)
    pre = [(it, r) for it, r in hist if r > 100.0 * floor]
    rates = [
        (r1 / r0) ** (1.0 / (i1 - i0))
        for (i0, r0), (i1, r1) in zip(pre, pre[1:])
        if i1 - i0 >= 20 and r1 < r0
    ]
    rho = max(rates) if rates else 0.99
    rho = min(max(float(rho), 0.5), 0.9995)
    amp = 1.0 / (1.0 - rho)
    print(f"[refined] measured rho={rho:.5f} (amplification {amp:.0f}x)",
          flush=True)

    def hbm():
        try:
            s = jax.local_devices()[0].memory_stats()
            return (f"{s['bytes_in_use'] / 2**30:.2f}"
                    f"/{s['bytes_limit'] / 2**30:.2f} GiB")
        except Exception:
            return "n/a"

    tm = jax.tree_util.tree_map
    leaves32, treedef = _flatten((res.u, res.Tc))
    x64 = [np.asarray(l, dtype=np.float64) for l in leaves32]
    x_norm = float(np.sqrt(sum(float((l ** 2).sum()) for l in x64)))
    base_Tc = np.asarray(res.Tc, dtype=np.float64)
    base_iters, base_res = res.iterations, float(res.residual)
    # Free the base solve's device state: the correction loop needs the
    # headroom (flagship state trees are ~1.1 GB each, and the base x
    # would sit on the device beside g/e/F(e)).
    for leaf in leaves32:
        leaf.delete()
    del res, leaves32
    print(f"[refined] device memory after base-state free: {hbm()}",
          flush=True)

    if base_tier != args.tier:
        # swap in the correction-tier solver: free the base solver's
        # device operators first (two const sets don't fit beside the
        # correction loop's 8 state trees at nx=16)
        import gc

        for leaf in jax.tree_util.tree_leaves(solver.consts):
            if hasattr(leaf, "delete"):
                leaf.delete()
        del solver
        gc.collect()
        t0 = time.time()
        solver = _build(args.nx, args.tier, "float32")
        print(f"[refined] correction solver ({args.tier}) setup "
              f"{time.time()-t0:.1f}s; device memory: {hbm()}", flush=True)

    worker_line()  # READY
    fin = os.path.join(wdir, "in.npz")
    fout = os.path.join(wdir, "out.npz")

    def defect():
        """d = F64(x64) - x64 (leaf list, f64) + its norm."""
        np.savez(fin, **{f"leaf_{i}": l for i, l in enumerate(x64)})
        t1 = time.time()
        worker.stdin.write(f"STEP {fin} {fout}\n")
        worker.stdin.flush()
        worker_line()  # DONE
        with np.load(fout) as z:
            d = [z[f"leaf_{i}"] - x64[i] for i in range(len(x64))]
        dn = float(np.sqrt(sum(float((l ** 2).sum()) for l in d)))
        print(f"[refined] defect ||d||={dn:.3e} "
              f"(bound {dn * amp / x_norm:.3e} rel; {time.time()-t1:.1f}s "
              f"incl. f64 step)", flush=True)
        return d, dn

    rounds = []
    certified = None
    t_refine0 = time.time()
    for rnd in range(args.rounds + 1):
        d, dn = defect()
        bound = dn * amp / x_norm
        rounds.append({"round": rnd, "defect_norm": dn,
                       "certified_rel_bound": bound})
        if bound <= args.target:
            certified = bound
            print(f"[refined] CERTIFIED {bound:.3e} <= {args.target:.0e} "
                  f"after {rnd} correction round(s)", flush=True)
            break
        if rnd == args.rounds:
            print(f"[refined] round budget exhausted at bound {bound:.3e}",
                  flush=True)
            break
        # ---- scaled f32 correction solve on the device ------------------------
        s_pow = float(2.0 ** np.round(np.log2(max(x_norm, 1e-300)
                                              / max(dn, 1e-300))))
        d32 = jax.tree_util.tree_unflatten(
            treedef,
            [jnp.asarray((l * s_pow).astype(np.float32)) for l in d],
        )

        def step_fn(u_, Tc_, Tv_):
            return solver._step_plain(solver.consts, u_, Tc_, Tv_)

        t1 = time.time()
        if args.inner == "krylov":
            e, nstep, relres = accel.correction_bicgstab(
                step_fn, solver.initial_state(), d32, tol=args.inner_tol,
                max_iter=args.inner_max_iter, verbose=True, check_every=5,
                consume_d=True,
            )
        else:
            e, nstep, relres = accel.correction_outer(
                step_fn, solver.initial_state(), d32, tol=args.inner_tol,
                max_iter=args.inner_max_iter, verbose=True, check_every=25,
                consume_d=True,
            )
        del d32
        e_leaves, _ = _flatten(e)
        x64 = [a + np.asarray(l, dtype=np.float64) / s_pow
               for a, l in zip(x64, e_leaves)]
        for leaf in e_leaves:
            leaf.delete()
        del e, e_leaves
        print(f"[refined] device memory after round {rnd}: {hbm()}",
              flush=True)
        x_norm = float(np.sqrt(sum(float((l ** 2).sum()) for l in x64)))
        rounds[-1].update({
            "s_pow": s_pow, "correction_steps": nstep,
            "correction_relres": relres,
            "correction_s": round(time.time() - t1, 1),
        })
        print(f"[refined] round {rnd}: s=2^{int(np.log2(s_pow))}, "
              f"{nstep} corr steps to relres {relres:.2e} "
              f"({time.time()-t1:.1f}s)", flush=True)

    worker.stdin.write("QUIT\n")
    worker.stdin.flush()
    worker.wait(timeout=60)
    wlog.close()

    if args.save_state:
        np.savez(args.save_state,
                 **{f"leaf_{i}": l for i, l in enumerate(x64)})
        print(f"[refined] saved refined f64 state to {args.save_state}",
              flush=True)

    # refined Tc field (f64) for the artifact's summary stats
    Tc64 = jax.tree_util.tree_unflatten(treedef, x64)[1]
    shift = float(np.linalg.norm(Tc64 - base_Tc)
                  / max(np.linalg.norm(Tc64), 1e-300))
    out = {
        "metric": "converge_flagship_refined",
        "problem": f"hex {args.nx}^3 p=2 (ne={solver.ne} D={solver.D}) "
                   f"K={solver.K} BS={solver.BS}",
        "tier": args.tier,
        "base_tier": base_tier,
        "target_rel_l2": args.target,
        "certified_rel_bound": certified,
        "met": certified is not None and certified <= args.target,
        "rho_measured": rho,
        "base": {"iterations": base_iters,
                 "residual": base_res,
                 "seconds": round(base_s, 1)},
        "rounds": rounds,
        "refine_seconds": round(time.time() - t_refine0, 1),
        "base_to_refined_field_shift_rel": shift,
        "note": (
            "certified a-posteriori: ||x - x*|| <= ||F64(x) - x||/(1-rho); "
            "F64 = one step of the float64 CPU twin (identical ring plan, "
            "state-tree leaves exchanged verbatim); correction solved at "
            "x-scale on the f32 device solver (accel.refined_solve method, "
            "tests/test_accel.py::test_refined_solve_reaches_1e8)"
        ),
        "inner": args.inner,
        "cmd": f"python scripts/converge_flagship_refined.py "
               f"--nx {args.nx} --tier {args.tier} --inner {args.inner}",
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[refined] wrote {args.out}", flush=True)
    return 0 if out["met"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
