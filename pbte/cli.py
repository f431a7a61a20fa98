"""Command-line driver mirroring the reference's `pbte_demo`.

Usage (flags mirror src/PhononBTE.cpp:36-65; README.md:35-56):

    python -m pbte.cli [-m MESH] [-c CONFIG] [-o ORDER] [-r REFINE]
                           [--tol TOL] [--max-iter N] [--dtype f32|f64]
                           [--face-mode mfem-parity|consistent]
                           [--cache-policy full|per-iteration]
                           [--platform default|cpu] [--out DIR] [--vtu]

Pipeline (ref: src/PhononBTE.cpp:20-417): load config + mesh (file or
builtin), scale by reference_length, refine, assemble, build angular
quadrature + phonon tables (writing the golden-format logs), solve, dump
Tc/coefficients, write the 2D temperature slice and optional ParaView VTU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

PRECISION_HELP = (
    "f32 matmul precision. 'default' lets the GPU run f32 dots on TF32 "
    "tensor cores (and the lattice ring stages its operands in bf16); "
    "'highest' runs every f32 dot in full f32, and XLA runs 'high' the "
    "same way on an H100; 'selective' raises only the ring's transport "
    "contractions to full f32. Flagship on an H100 after 11 steps, "
    "relative L2 distance of Tc from f64: default 3.3e-4, selective "
    "2.1e-4, high/highest 2.2e-7, at ~1.2x the default step time"
)


def _setup_jax(platform: str, x64: bool):
    import jax

    from pbte.device import enable_compile_cache

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    return jax


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pbte", description=__doc__)
    ap.add_argument("-m", "--mesh", default="", help="mesh file or builtin name")
    ap.add_argument("-c", "--config", default="config/config.yaml")
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-r", "--refine", type=int, default=0)
    # angle overrides, negative/empty = use config (ref README.md:56;
    # src/PhononBTE.cpp option table)
    ap.add_argument("-ad", "--angle-dim", type=int, default=-1,
                    help="angular dimension override: 2 (in-plane) or 3")
    ap.add_argument("-ap", "--polar-pts", type=int, default=-1,
                    help="polar point count override")
    ap.add_argument("-az", "--azimuth-pts", type=int, default=-1,
                    help="azimuth point count override")
    ap.add_argument("-aps", "--polar-scheme", default="",
                    choices=["", "gauss", "uniform"],
                    help="polar scheme override")
    ap.add_argument("-aas", "--azimuth-scheme", default="",
                    choices=["", "gauss", "uniform"],
                    help="azimuth scheme override")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    ap.add_argument("--face-mode", choices=["mfem-parity", "consistent"],
                    default="mfem-parity")
    ap.add_argument("--cache-policy",
                    choices=["full", "on-the-fly", "per-iteration", "eigen"],
                    default="full")
    ap.add_argument("--sweep-mode", choices=["auto", "scan", "ring"],
                    default="auto",
                    help="'ring' = slab-major wavefront sweep with static "
                         "or one-hot neighbor selection (the fast path, "
                         "auto-selected at scale); 'scan' = compact "
                         "level-window scan")
    ap.add_argument("--polish-extrapolate", action="store_true",
                    help="after --polish, Aitken-extrapolate the slow "
                         "quasi-neutral mode's geometric tail (2 extra "
                         "exact steps) — removes the offset-family bias "
                         "plain polish cannot contract")
    ap.add_argument("--polish", type=int, default=0, metavar="N",
                    help="after convergence, run N full-f32-precision "
                         "iterations from the converged state — "
                         "contracts the default-precision field bias by "
                         "rho^N at a fraction of a full exact solve")
    ap.add_argument("--matmul-precision",
                    choices=["default", "high", "highest", "selective"],
                    default="default",
                    help=PRECISION_HELP)
    ap.add_argument("--slice-z", type=float, default=None,
                    help="3D only: sample a z=SLICE_Z plane of T and Q, with "
                         "SLICE_Z in units of reference_length — the legacy "
                         "z = 0.4*L_REF convention (output_3D_2Dslice_T_Q)")
    ap.add_argument("--line-slice", nargs=3, type=float, default=None,
                    metavar=("AXIS", "C1", "C2"),
                    help="3D only: sample T and Q along axis AXIS (0/1/2) at "
                         "fixed other coords C1 C2 in units of "
                         "reference_length (legacy output_3D_1Dslice_T_Q)")
    ap.add_argument("--diffuse", default="",
                    help="comma-separated boundary attrs with DIFFUSE walls "
                         "(legacy BC type 2, Lambert reflection; lagged)")
    ap.add_argument("--specular", default="",
                    help="comma-separated boundary attrs with SPECULAR walls "
                         "(legacy BC type 3, mirror reflection; lagged; "
                         "axis-aligned faces + mirror-symmetric quadrature)")
    ap.add_argument("--periodic", default="",
                    help="comma-separated axes (e.g. '0' or '0,1') to make "
                         "periodic by matching opposite boundary vertices; "
                         "gmsh meshes with $Periodic records pair "
                         "automatically")
    ap.add_argument("--platform", choices=["default", "cpu"], default="default")
    ap.add_argument("--out", default="output")
    ap.add_argument("--vtu", action="store_true", help="write ParaView VTU output")
    ap.add_argument("--vtu-every", type=int, default=0, metavar="N",
                    help="write a ParaView time-series collection (.pvd + "
                         "cycle directories, like the reference's "
                         "ParaViewDataCollection) every N outer iterations")
    ap.add_argument("--no-dumps", action="store_true",
                    help="skip golden-format log dumps")
    ap.add_argument("--check-every", type=int, default=1)
    ap.add_argument("--accelerate", choices=["none", "bicgstab"],
                    default="none",
                    help="Krylov-accelerate the outer iteration: 'bicgstab' "
                         "solves the same fixed point as a linear system "
                         "with one plain step per matvec (~6x fewer steps "
                         "to tolerance; see solver/accel.py)")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint file path (npz); written every "
                         "--checkpoint-every iterations during the solve")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="resume the solve from --checkpoint if it exists")
    ap.add_argument("--profile", default="",
                    help="write a jax profiler trace of the solve to this dir")
    ap.add_argument("-p", "--parallel", default="",
                    help="run the domain-decomposed solver over a DIRxSPACE "
                         "device mesh, e.g. '2x4' (needs dir*space devices)")
    args = ap.parse_args(argv)
    if args.accelerate != "none":
        # Krylov recurrences need exact-dtype state; override the bf16
        # state-storage flag before the solver is constructed
        os.environ["PBTE_RING_STATE_BF16"] = "0"


    jax = _setup_jax(args.platform, x64=(args.dtype == "f64"))
    import jax.numpy as jnp
    import numpy as np

    from pbte import mesh as pmesh
    from pbte.angular import quadrature as ang
    from pbte.config import load_run_config
    from pbte.fem import assembly
    from pbte.material import nongray_smrt
    from pbte.io import writers
    from pbte.io.slice import write_2d_slice
    from pbte.mesh.summary import write_summary
    from pbte.solver.source_iteration import SourceIterationSolver
    from pbte.sweep import planner

    if os.path.exists(args.config):
        rc = load_run_config(args.config)
    else:
        from pbte.config import RunConfig

        rc = RunConfig()
        print(f"[pbte] config {args.config} not found; using defaults")
    # CLI angle overrides take precedence over the YAML block (negative /
    # empty = keep config), mirroring the reference's -ad/-ap/-az/-aps/-aas
    # (README.md:56); applied before the BC defaulting below, which keys
    # off the angular dimension
    import dataclasses as _dc

    ang_over = {}
    if args.angle_dim > 0:
        ang_over["dimension"] = args.angle_dim
    if args.polar_pts > 0:
        ang_over["polar_points"] = args.polar_pts
    if args.azimuth_pts > 0:
        ang_over["azimuth_points"] = args.azimuth_pts
    if args.polar_scheme:
        ang_over["polar_scheme"] = args.polar_scheme
    if args.azimuth_scheme:
        ang_over["azimuth_scheme"] = args.azimuth_scheme
    if ang_over:
        rc.angles = _dc.replace(rc.angles, **ang_over)
    if not rc.bc_temps:
        # default isothermal BCs for builtin Cartesian meshes: top boundary
        # hot (+0.5), all others cold (-0.5) — the reference demo's setup
        hot = 3 if rc.angles.dimension == 2 else 6
        nattr = 4 if rc.angles.dimension == 2 else 6
        rc.bc_temps = {a: (0.5 if a == hot else -0.5) for a in range(1, nattr + 1)}
        print(f"[pbte] no boundary_conditions configured; using defaults "
              f"{rc.bc_temps}")
    if args.mesh:
        rc.mesh_spec = args.mesh
    if args.diffuse:
        attrs = [int(x) for x in args.diffuse.split(",")]
        rc.diffuse_attrs = sorted(set(rc.diffuse_attrs) | set(attrs))
        for a in attrs:
            rc.bc_temps.pop(a, None)  # the flag overrides a default/iso BC
    if args.specular:
        attrs = [int(x) for x in args.specular.split(",")]
        rc.specular_attrs = sorted(set(rc.specular_attrs) | set(attrs))
        for a in attrs:
            rc.bc_temps.pop(a, None)
    rc.order = args.order
    rc.refine = args.refine
    if args.tol is not None:
        rc.tolerance = args.tol
    if args.max_iter is not None:
        rc.max_iter = args.max_iter
    rc.output_dir = args.out

    log_dir = os.path.join(rc.output_dir, "log")
    os.makedirs(log_dir, exist_ok=True)

    t0 = time.time()
    m = pmesh.load_mesh(rc.mesh_spec)
    m = m.scaled(rc.material.ref_len)
    m = pmesh.uniform_refine(m, rc.refine)
    if args.periodic:
        axes = [int(x) for x in args.periodic.split(",")]
        m = pmesh.make_periodic(m, axes)
    topo = pmesh.connect(m)
    n_per = int(topo.elem_face_periodic.sum())
    if (rc.periodic_attrs or args.periodic) and n_per == 0:
        raise SystemExit(
            "[pbte] periodic boundaries requested but no face pairs "
            "matched (mesh lacks $Periodic records; try --periodic AXES)"
        )
    print(f"[pbte] mesh: {m.geom} dim={m.dim} ne={m.num_elements} "
          f"nv={m.num_vertices}"
          + (f" periodic_faces={n_per}" if n_per else "")
          + f" ({time.time()-t0:.1f}s)")

    ops = assembly.assemble(topo, order=rc.order, face_mode=args.face_mode)
    print(f"[pbte] assembled p={rc.order} D={ops.ndof} "
          f"faces/elem={ops.faces_per_elem} ({time.time()-t0:.1f}s)")

    quad = ang.build(rc.angles)
    tables = nongray_smrt.build_tables(rc.material, num_spectral=rc.n_spectral)
    print(f"[pbte] angles: K={quad.num_directions} total_weight="
          f"{quad.total_weight:.6g}; bands: {tables.num_branches}x"
          f"{tables.num_spectral}; HeatCapV={tables.heat_cap_v:.6g}")

    if not args.no_dumps:
        mesh_name = os.path.splitext(os.path.basename(str(rc.mesh_spec)))[0]
        scheme_p = rc.angles.polar_scheme
        scheme_a = rc.angles.azimuth_scheme
        tag = (f"dim{rc.angles.dimension}_np{rc.angles.polar_points}_{scheme_p}"
               f"_na{rc.angles.azimuth_points}_{scheme_a}")
        write_summary(topo, rc.order, ops.ndof * m.num_elements,
                      os.path.join(log_dir, f"mesh_{mesh_name}_p{rc.order}_dim{m.dim}.txt"))
        ang.write_quadrature(quad, os.path.join(log_dir, f"angles_{tag}.txt"))
        planner.write_sweep_orders(quad, topo, os.path.join(log_dir, f"sweep_{tag}.txt"))
        nongray_smrt.write_tables(tables, os.path.join(log_dir, "phonon_properties.txt"))

    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    if args.parallel:
        import numpy as _np
        from jax.sharding import Mesh

        from pbte.parallel.spatial import SpatialShardedSolver

        try:
            n_dir, n_space = (int(x) for x in args.parallel.lower().split("x"))
        except ValueError:
            raise SystemExit(
                f"--parallel expects DIRxSPACE (e.g. 2x4), got {args.parallel!r}"
            )
        devs = jax.devices()
        if len(devs) < n_dir * n_space:
            raise SystemExit(
                f"--parallel {args.parallel} needs {n_dir * n_space} devices, "
                f"found {len(devs)}"
            )
        if args.cache_policy != "full" or args.matmul_precision != "default":
            print("[pbte] WARNING: --cache-policy/--matmul-precision are "
                  "not supported by the --parallel solver (it always builds "
                  "the full A^-1 cache at default precision); ignoring")
        dmesh = Mesh(_np.array(devs[: n_dir * n_space]).reshape(n_dir, n_space),
                     axis_names=("dir", "space"))
        # production path: slab-lattice ring decomposition (class-batched
        # factors, ppermute exit-layer halo, Dirichlet + plane-periodic +
        # diffuse/specular); general meshes fall back to SpatialShardedSolver
        try:
            from pbte.parallel.slab import SlabLatticeSolver

            solver = SlabLatticeSolver(
                ops, quad, tables, rc.bc_temps, device_mesh=dmesh,
                dtype=dtype, dirichlet_bcs=rc.dirichlet_bcs or None,
                diffuse_bcs=rc.diffuse_attrs or None,
                specular_bcs=rc.specular_attrs or None,
            )
            print(f"[pbte] slab-lattice solver: mesh (dir={n_dir}, "
                  f"space={n_space}), slabs={solver.P} along axis "
                  f"{solver.a0}, W={solver.W} L={solver.L} "
                  f"({time.time()-t0:.1f}s)")
        except NotImplementedError as e:
            solver = SpatialShardedSolver(
                ops, quad, tables, rc.bc_temps, device_mesh=dmesh, topo=topo,
                dtype=dtype, dirichlet_bcs=rc.dirichlet_bcs or None,
                diffuse_bcs=rc.diffuse_attrs or None,
                specular_bcs=rc.specular_attrs or None,
            )
            print(f"[pbte] parallel solver (general mesh: {e}): "
                  f"mesh (dir={n_dir}, space={n_space}), "
                  f"partitions={solver.pplan.nparts} "
                  f"interface={solver.pplan.num_interface} "
                  f"edge_cut={solver.pplan.edge_cut()} "
                  f"load_balance={solver.pplan.load_balance():.2f} "
                  f"({time.time()-t0:.1f}s)")
    else:
        solver = SourceIterationSolver(
            ops, quad, tables, rc.bc_temps, dtype=dtype,
            dirichlet_bcs=rc.dirichlet_bcs or None,
            diffuse_bcs=rc.diffuse_attrs or None,
            specular_bcs=rc.specular_attrs or None,
            sweep_mode=args.sweep_mode,
            cache_policy=args.cache_policy,
            matmul_precision=(None if args.matmul_precision == "default"
                              else args.matmul_precision),
        )
        print(f"[pbte] solver[{solver.sweep_mode}]: groups={solver.plan.num_groups} "
              f"levels<={solver.plan.max_levels} width<={solver.plan.max_width} "
              f"padding={solver.plan.padding_ratio():.1%} ({time.time()-t0:.1f}s)")

    state = None
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        from pbte.io.checkpoint import load_checkpoint

        state, ck_it, ck_res = load_checkpoint(args.checkpoint, solver)
        print(f"[pbte] resumed from {args.checkpoint} "
              f"(iteration {ck_it}, residual {ck_res:.3e})")

    history = []
    solve_kw = dict(
        tol=rc.tolerance, max_iter=rc.max_iter, state=state,
        check_every=args.check_every,
        callback=lambda it, r: history.append((it, r)),
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
    )
    if args.accelerate != "none":
        # both domain-decomposed solvers accept accelerate= too (lagged
        # ppermute halos are linear in the previous iterate; accel.py)
        solve_kw["accelerate"] = args.accelerate
    if args.polish > 0:
        solve_kw["polish_iters"] = args.polish
        solve_kw["polish_extrapolate"] = args.polish_extrapolate
    pv_coll = None
    if args.vtu_every > 0:
        from pbte.io.vtu import ParaViewCollection

        # parallel runs write one .vtu piece per partition under each
        # cycle's .pvtu (the reference's parallel WriteParaView saves
        # per-rank pieces, ref: src/MacroscopicQuantities.cpp:168-271)
        pv_coll = ParaViewCollection(
            m, rc.order, name="pbte_fields",
            root=os.path.join(rc.output_dir, "vis"),
            part=(solver.element_partition if args.parallel else None),
        )

        def _cycle_hook(it, u_c, Tc_c, Tv_c):
            Qc_c = np.asarray(solver.heat_flux(u_c)[0])
            Tc_c = (solver.gather_Tc(Tc_c) if args.parallel
                    else solver.Tc_fine(Tc_c))
            pv_coll.save({"T": Tc_c}, {"Q": Qc_c}, cycle=it)

        solve_kw["cycle_hook"] = _cycle_hook
        solve_kw["cycle_every"] = args.vtu_every
    t1 = time.time()
    if args.profile:
        with jax.profiler.trace(args.profile):
            res = solver.solve(**solve_kw)
        print(f"[pbte] profiler trace written to {args.profile}")
    else:
        res = solver.solve(**solve_kw)
    t_solve = time.time() - t1
    dof_swept = (res.iterations * solver.K * solver.BS
                 * m.num_elements * ops.ndof)
    print(f"[pbte] done: {res.iterations} iters, residual {res.residual:.3e}, "
          f"{t_solve:.2f}s, {dof_swept / max(t_solve, 1e-9):.3e} "
          f"element-ordinate DOF/s")

    # step-residual history (analog of the legacy
    # PBTE_NonGraySMRT_step_resisual.txt, typo preserved;
    # ref: reference/DGSolver/PBTE_NonGraySMRT.cpp:72-76,143)
    hist_dir = os.path.join(rc.output_dir, f"{m.dim}D/log")
    os.makedirs(hist_dir, exist_ok=True)
    with open(os.path.join(hist_dir,
                           "PBTE_NonGraySMRT_step_resisual.txt"), "w") as f:
        for it, r in history:
            f.write(f"{it} {r}\n")

    # outputs are identical regardless of --parallel (the reference gathers
    # per-rank blocks for multi-rank-comparable dumps, src/Utils.cpp:100-148)
    Tc_out = (
        res.Tc_global() if args.parallel else solver.Tc_fine(res.Tc)
    )
    if not args.no_dumps:
        writers.write_temperature(Tc_out, os.path.join(log_dir, "Tc_all.txt"))
        writers.write_coefficients(res.u_dirs(), quad, tables.num_branches,
                                   os.path.join(log_dir, "coeff_all.txt"))
        writers.write_element_integrals(ops, os.path.join(log_dir, "integrals_all.txt"))
    if m.dim == 2:
        write_2d_slice(m, rc.order, Tc_out,
                       os.path.join(rc.output_dir, "2D/results/T_slice.txt"), 100, 100)
        print(f"[pbte] 2D temperature slice written to "
              f"{rc.output_dir}/2D/results/T_slice.txt")
    if m.dim != 3 and (args.slice_z is not None or args.line_slice is not None):
        print("[pbte] WARNING: --slice-z/--line-slice are 3D-only; "
              f"ignored for this {m.dim}D mesh")
    if m.dim == 3 and (args.slice_z is not None or args.line_slice is not None):
        from pbte.io.slice import write_3d_line_slice, write_3d_slice

        Qc3 = np.asarray(solver.heat_flux(res.u)[0])
        res_dir = os.path.join(rc.output_dir, "3D/results")
        # slice coordinates are in units of reference_length, matching the
        # legacy driver's z = 0.4 * L_REF convention (ref: Reference
        # Project/src/PhononBTE/PhononBTE.cpp:166-168) — the mesh itself
        # was scaled to physical metres above
        scale = rc.material.ref_len
        if args.slice_z is not None:
            path = os.path.join(res_dir, "T_slice_z.txt")
            write_3d_slice(m, rc.order, Tc_out, Qc3, args.slice_z * scale,
                           path)
            print(f"[pbte] 3D plane slice written to {path}")
        if args.line_slice is not None:
            axis, c1, c2 = args.line_slice
            path = os.path.join(res_dir, "T_line.txt")
            write_3d_line_slice(m, rc.order, Tc_out, Qc3, int(axis),
                                c1 * scale, c2 * scale, path)
            print(f"[pbte] 3D line slice written to {path}")
    if pv_coll is not None:
        Qc = np.asarray(solver.heat_flux(res.u)[0])
        pvd = pv_coll.save({"T": Tc_out}, {"Q": Qc}, cycle=res.iterations)
        print(f"[pbte] ParaView collection written to {pvd}")
    if args.vtu:
        Qc = np.asarray(solver.heat_flux(res.u)[0])
        if args.parallel:
            from pbte.io.vtu import write_pvtu

            part = solver.element_partition
            pieces = [
                (ids, {"T": Tc_out[ids]}, {"Q": Qc[:, ids]})
                for p in range(int(part.max()) + 1)
                for ids in (np.flatnonzero(part == p),)
            ]
            write_pvtu(m, rc.order, pieces,
                       os.path.join(rc.output_dir, "vis/pbte_fields"))
        else:
            from pbte.io.vtu import write_vtu

            write_vtu(m, rc.order, {"T": Tc_out}, {"Q": Qc},
                      os.path.join(rc.output_dir, "vis/pbte_fields"))
        print(f"[pbte] ParaView output written to {rc.output_dir}/vis/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
