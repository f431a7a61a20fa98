"""Krylov-accelerated source iteration (BiCGStab over the solver state).

The outer source iteration is AFFINE: one step is x' = F(x) = A x + b with
state x = (u, Tc) — the sweep solve is linear in (u_old, Tc_old), the
macroscopic closure is linear in u_new, and every boundary term (isothermal,
Dirichlet, lagged diffuse/specular/periodic) is constant or linear in the
previous iterate. The reference iterates this map plainly to tolerance
(ref: src/PBTESolver.cpp:208-332), paying one step per factor-of-rho error
reduction (rho ~ 0.98 on the flagship: 860 iterations to 1e-8). The fixed
point solves the linear system

    M x = b,   M = I - A,   M v = v - (F(v) - F(0)),

so any Krylov method whose matvec is ONE plain solver step applies.

Why BiCGStab and not a Chebyshev semi-iteration: the sweep operator
is strongly NONNORMAL and its upper spectrum is a COMPLEX ARC — a 40-step
Arnoldi on the hex-8^3 problem puts Ritz values at 0.98 +/- 0.14i and
1.01 +/- 0.10i (transient pseudospectrum beyond the unit circle even though
the plain iteration converges). Chebyshev on a real interval [0, rho] was
implemented first and measured DIVERGENT here for exactly this reason (the
error polynomial is >1 on the off-axis arc); interval enlargement never
recovers. Measured matvec counts on hex-8^3 to linear relres 1e-9
(plain fixed point: 1130 iterations to 1e-10):

    gmres(restart=8)   323      (m+3 state copies)
    gmres(restart=40)  242      (43 state copies — infeasible at scale)
    bicgstab           164      (~8 state copies, restart-free)

BiCGStab wins on both matvecs and memory: ~7x fewer steps than the plain
iteration at O(1) extra state. All vector ops run device-side on the
solver's state pytree, scalars stay 0-d device arrays (no host fetch inside
an iteration); the host only orchestrates and periodically reads the
residual norm for the stopping test — the same cadence as the plain loop's
check_every.

Breakdown safety: |rho| or |rhat . v| collapsing (the classic BiCGStab
breakdowns) triggers a restart with rhat = r. The method is exact-affine:
with f64 state it reproduces the plain fixed point to the linear tolerance
(oracle-matched in tests/test_accel.py).

Precision envelope (MEASURED): in float32 the step is only affine to a
~2.7e-3 additivity defect on Krylov-typical (random-like) inputs — exact
CPU f32 ops, no bf16 involved; the defect is catastrophic cancellation
across the non-gray band scales (invKn spans orders of magnitude and the
relaxation term differences large near-equal quantities). Every Krylov
method floors there: measured stalls at hex-8^3 f32 — bicgstab 6.7e-2
(even with f64 recurrences via scipy), gmres(8) 7.9e-3. The plain
fixed-point iteration is SELF-CORRECTING and converges through that noise
(f32 flagship reaches 1e-8), Krylov recurrences are not. Consequences:
  - f64 state: full ~6x acceleration to deep tolerances,
  - f32 state: acceleration to moderate (engineering) tolerance only;
    the stagnation guard stops the solve at the floor, and deep-tolerance
    f32 runs should use the plain iteration.
"""

from __future__ import annotations


def tree_dot(x, y):
    """Sum over leaves of <x, y>. bf16 leaves accumulate in f32 (a bf16
    inner product is useless for Krylov recurrences); f32/f64 leaves keep
    their own precision."""
    import jax
    import jax.numpy as jnp

    def vdot(a, b):
        if a.dtype == jnp.bfloat16:
            return jnp.vdot(a.astype(jnp.float32), b.astype(jnp.float32))
        return jnp.vdot(a, b)

    parts = [
        vdot(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(x),
                        jax.tree_util.tree_leaves(y))
    ]
    return sum(parts[1:], parts[0])


def tree_comb(coeffs_and_trees):
    """Linear combination sum_i c_i * t_i over matching pytrees."""
    import jax

    (c0, t0), *rest = coeffs_and_trees

    def leaf(*ls):
        acc = c0 * ls[0]
        for (c, _), l in zip(rest, ls[1:]):
            acc = acc + c * l
        return acc

    return jax.tree_util.tree_map(leaf, t0, *[t for _, t in rest])


def bicgstab_outer(step_fn, zero_state, state, tol, max_iter, verbose=True,
                   callback=None, check_every=1, save_ckpt=None,
                   ckpt_every=25, label="pbte", sync_every=10):
    """Generic BiCGStab outer solve over a solver's (u, Tc) state pytree.

    step_fn(u, Tc, Tv_prev) -> (u', Tc', Tv', res) must be the solver's
    NON-donating jitted step (the Krylov recurrence re-reads x after F(x));
    Tv_prev only feeds the reported residual. zero_state = (u0, Tc0, Tv0)
    all-zero. Works for any solver whose step is affine in (u, Tc) — the
    single-device SourceIterationSolver and both domain-decomposed solvers
    (lagged ppermute halos are linear in the previous iterate).

    Returns (u_f, Tc_f, Tv_f, tv_residual, n_step_applications). The final
    two entries come from TWO trailing plain steps: the first recovers Tv at
    the converged x, the second yields the reference-style Tv residual —
    solver-agnostic (no access to the macro closure needed) at the cost of
    one extra matvec. The trailing steps are reserved inside the loop guard,
    so n_step_applications <= max_iter whenever max_iter >= 3 (b=F(0) + the
    two trailing steps are the unconditional floor; a warm start adds one
    more). save_ckpt(u, Tc, nmv, res) fires every ckpt_every BiCGStab
    iterations (= 2*ckpt_every step applications)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    u0, Tc0, Tv0 = zero_state

    def F(x):
        u, Tc, _, _ = step_fn(x[0], x[1], Tv0)
        return (u, Tc)

    b_aff = F((u0, Tc0))  # b = F(0)
    nmv = 1

    # XLA:CPU in-process collectives deadlock when collectives from
    # DIFFERENT executables are in flight concurrently on a small thread
    # pool (each blocked rendezvous pins a pool thread; with >=2 programs
    # interleaved across the per-device queues the remaining threads can
    # all be waiters — measured abort at 4 forced host devices, fine at 8).
    # The plain solve loop has ONE executable and only needs bounded async
    # depth; the Krylov loop dispatches FIVE collective-bearing programs
    # per iteration (2 matvecs + 3 stage kernels with tree_dot all-reduces),
    # so on multi-device CPU serialize fully: at most one program in
    # flight. Accelerators and single-device CPU are unaffected.
    _leaf = jax.tree_util.tree_leaves(b_aff)[0]
    try:
        _ndev = len(_leaf.sharding.device_set)
    except AttributeError:  # pragma: no cover - non-Array leaf
        _ndev = 1
    serialize = jax.default_backend() == "cpu" and _ndev > 1
    if serialize:
        jax.block_until_ready(b_aff)

    sub = jax.jit(
        lambda v, Fv, b: jax.tree_util.tree_map(
            lambda a, c, d: a - (c - d), v, Fv, b
        )
    )
    diff = jax.jit(
        lambda a, c: jax.tree_util.tree_map(lambda x1, x2: x1 - x2, a, c)
    )

    def Mop(v):
        nonlocal nmv
        nmv += 1
        out = sub(v, F(v), b_aff)
        if serialize:
            jax.block_until_ready(out)
        return out

    stage_p, stage_s, stage_x = make_bicgstab_kernels()
    _copy = lambda tr: jax.tree_util.tree_map(lambda a: a.copy(), tr)
    if state is not None:
        # defensive copy: stage_x DONATES x, and the warm-start arrays
        # belong to the caller
        x = (_copy(state[0]), _copy(state[1]))
        r = diff(F(x), x)
        nmv += 1
        if serialize:
            jax.block_until_ready(r)
    else:
        # fresh zero buffers: stage_x donates x (zero_state may be reused
        # by the caller), and stage_s donates r while b_aff must stay live
        # inside Mop
        x = jax.tree_util.tree_map(jnp.zeros_like, (u0, Tc0))
        r = _copy(b_aff)
    # rhat must be a distinct buffer: stage_s donates r while rhat stays live
    rhat = _copy(r)
    leaf0 = jax.tree_util.tree_leaves(Tc0)[0]
    one = jnp.asarray(1.0, dtype=leaf0.dtype)
    rho_prev = alpha = omega = one
    # p and v are donated by stage_p — they must not alias each other
    v = jax.tree_util.tree_map(jnp.zeros_like, r)
    p = jax.tree_util.tree_map(jnp.zeros_like, r)
    bnorm = float(jnp.sqrt(tree_dot(b_aff, b_aff)))
    res = float("inf")
    k = 0  # BiCGStab iterations (2 matvecs each)
    fetch_every = max(1, check_every // 2)
    best = float("inf")
    stale = 0  # fetches without a >=10% improvement: noise-floor detector
    # (at default f32 matmul precision an accelerator may round matmul
    # operands — TF32 or bf16 — so the matvec carries relative noise that
    # Krylov recurrences stagnate at instead of self-correcting like the
    # plain fixed-point iteration; stop instead of burning matvecs. Use
    # matmul_precision="highest" to push the accelerated solve to deep
    # tolerances.)
    # The window must be cadence-INDEPENDENT: BiCGStab residuals on the
    # nonnormal sweep operator routinely plateau for ~10-40 matvecs mid-
    # solve before resuming, so at check_every=1 a pure 6-fetch rule fires
    # spuriously (measured: 2D reference config stopped at 1.6e-5 on the
    # way to 3.6e-10). Require BOTH >=6 stale fetches AND >=60 matvecs
    # since the last 10% improvement.
    last_gain_nmv = nmv
    # +4 reserves this iteration's two matvecs AND the two trailing plain
    # steps, so the returned count stays within max_iter
    while nmv + 4 <= max_iter:
        rho, p = stage_p(r, rhat, p, v, rho_prev, alpha, omega)
        if serialize:
            jax.block_until_ready(p)
        v = Mop(p)
        alpha, s = stage_s(r, rhat, v, rho)
        if serialize:
            jax.block_until_ready(s)
        t = Mop(s)
        omega, x, r, rnorm2 = stage_x(x, p, s, t, alpha)
        if serialize:
            jax.block_until_ready(rnorm2)
        rho_prev = rho
        k += 1
        if sync_every and k % max(1, sync_every // 2) == 0:
            # bound the async dispatch depth: the XLA CPU backend's
            # in-process collectives ABORT (rendezvous timeout) when many
            # collective executions are enqueued without a host sync —
            # same mitigation as the plain domain-decomposed solve loops
            jax.block_until_ready(rnorm2)
        # fetch the residual scalar EVERY iteration: it bounds the host's
        # dispatch depth to one iteration. Every in-flight iteration pins
        # its own generation of state trees, so an unbounded run-ahead
        # multiplies the live set on large states; one scalar per two
        # full-sweep matvecs costs nothing measurable. Cadence of the
        # printing/stopping logic below is unchanged.
        rn = float(rnorm2) ** 0.5
        if k % fetch_every == 0 or nmv + 4 > max_iter:
            res = rn / bnorm if bnorm > 0 else rn
            if verbose:
                print(f"[{label}] matvec {nmv}, linear relres = {res:.6e}")
            if callback is not None:
                callback(nmv, res)
            if not np.isfinite(res) or abs(float(rho)) < 1e-300:
                if nmv + 3 > max_iter:
                    # no budget for the restart matvec + the two trailing
                    # steps; exit with the current x (keeps the returned
                    # count within max_iter)
                    break
                # BiCGStab breakdown: restart the recurrence at x
                r = diff(F(x), x)
                nmv += 1
                if serialize:
                    jax.block_until_ready(r)
                rhat = _copy(r)
                rho_prev = alpha = omega = one
                v = jax.tree_util.tree_map(jnp.zeros_like, r)
                p = jax.tree_util.tree_map(jnp.zeros_like, r)
                if verbose:
                    print(f"[{label}] bicgstab restart (breakdown)")
                continue
            if res < tol:
                break
            if res < 0.9 * best:
                best, stale, last_gain_nmv = res, 0, nmv
            else:
                stale += 1
                if stale >= 6 and nmv - last_gain_nmv >= 60:
                    if verbose:
                        print(f"[{label}] bicgstab stagnated at relres "
                              f"{res:.3e} (matvec noise floor); stopping")
                    break
        if save_ckpt is not None and k % ckpt_every == 0:
            # fetch the CURRENT residual for the metadata (the checkpoint
            # cadence need not be a multiple of the fetch cadence, so `res`
            # can be stale or still inf here); one scalar fetch per save
            rn_ck = float(rnorm2) ** 0.5
            save_ckpt(x[0], x[1], nmv,
                      rn_ck / bnorm if bnorm > 0 else rn_ck)
    # two plain steps: recover Tv at x, then the reference-style residual
    u1, Tc1, Tv1, _ = step_fn(x[0], x[1], Tv0)
    if serialize:
        jax.block_until_ready(Tc1)
    u_f, Tc_f, Tv_f, res_dev = step_fn(u1, Tc1, Tv1)
    nmv += 2
    tv_res = float(res_dev)
    if verbose:
        print(f"[{label}] bicgstab done: {nmv} step applications, "
              f"linear relres {res:.3e}, Tv residual {tv_res:.6e}")
    return u_f, Tc_f, Tv_f, tv_res, nmv


def make_bicgstab_kernels():
    """The three fused device-side updates between the two matvecs of a
    BiCGStab iteration (jitted once; scalars are 0-d arrays). Dead operands
    are donated so XLA reuses their buffers — at the hex-16^3 flagship each
    state tree is ~1.1 GB f32 and the peak live-set is what decides whether
    the accelerated solve fits beside the solver constants:
      - stage_p donates the previous iteration's p (replaced before its
        next read),
      - stage_s donates r (r_new comes out of stage_x),
      - stage_x donates x and s (x_new replaces x; s is dead after)."""
    import jax

    def _stage_p(r, rhat, p, v, rho_prev, alpha, omega):
        rho = tree_dot(rhat, r)
        beta = (rho / rho_prev) * (alpha / omega)
        p_new = tree_comb([(1.0, r), (beta, p), (-beta * omega, v)])
        return rho, p_new

    # only p is donated: stage_p has a single tree-shaped output, so a
    # second donated operand (v) would be unusable (and warn); the old v's
    # buffer is freed at rebinding anyway
    stage_p = jax.jit(_stage_p, donate_argnums=(2,))

    def _stage_s(r, rhat, v, rho):
        alpha = rho / tree_dot(rhat, v)
        s = tree_comb([(1.0, r), (-alpha, v)])
        return alpha, s

    stage_s = jax.jit(_stage_s, donate_argnums=(0,))

    def _stage_x(x, p, s, t, alpha):
        omega = tree_dot(t, s) / tree_dot(t, t)
        x_new = tree_comb([(1.0, x), (alpha, p), (omega, s)])
        r_new = tree_comb([(1.0, s), (-omega, t)])
        rnorm2 = tree_dot(r_new, r_new)
        return omega, x_new, r_new, rnorm2

    stage_x = jax.jit(_stage_x, donate_argnums=(0, 2))

    return stage_p, stage_s, stage_x


def compensated_outer(step_fn, zero_state, state, tol, max_iter,
                      verbose=True, callback=None, check_every=1):
    """Double-f32 (compensated) fixed-point iteration: the state (u, Tc) is
    carried as an unevaluated SUM of two f32 trees (x, e) with ~2^-48
    effective resolution — implemented and MEASURED REFUTED as a bias
    remover (kept as the tested vehicle).

    The outer step is AFFINE, F(z) = A z + b (module docstring), so the
    step of the pair needs no double-double arithmetic inside the sweep:

        F(x + e) = F(x) + (F(e) - F(0))        [exactly, by affinity]

    i.e. one plain step on the value part plus one HOMOGENEOUS step on the
    error part (b = F(0) precomputed), recombined with Knuth's branch-free
    TwoSum per leaf (exact in IEEE f32):

        s = dx + de;  z = s - dx;  err = (dx - (s - z)) + (de - z)

    MEASURED (hex 6^3, CPU f32 — exact dots, no operand rounding, vs f64
    truth): plain f32 and compensated f32 converge to the IDENTICAL
    1.83e-6 relative-L2 floor (tests/test_accel.py). The floor is the f32
    rounding of the step's OWN OUTPUTS (each level solve rounds its result
    to f32 before the next level consumes it), which the compensated STATE
    cannot see — state-storage rounding was never the binding term.
    Conclusion: the 1e-8 field north star needs the step's output error
    corrected, not the state representation widened — that is
    `refined_solve` below (iterative refinement with an f64 defect), whose
    floor is ~|e|*1e-6 ~ 1e-12. Cost here: two step applications per
    outer iteration.

    step_fn must be the solver's NON-donating jitted step at the desired
    matmul precision; zero_state = (u0, Tc0, Tv0) all-zero. Returns
    (x_u, x_Tc, Tv, residual, n_step_applications) with the error part
    FOLDED INTO nothing — callers read the converged field from the value
    part (|e| ~ 2^-24 |x| at convergence, below every output format).
    """
    import jax

    u0, Tc0, Tv0 = zero_state

    def F(z):
        u, Tc, _, _ = step_fn(z[0], z[1], Tv0)
        return (u, Tc)

    b_aff = F((u0, Tc0))  # b = F(0)
    nstep = 1

    def _two_sum_combine(dx, de_full, b):
        # de = F(e) - b (homogeneous part), then TwoSum(dx, de) per leaf
        tm = jax.tree_util.tree_map
        de = tm(lambda c, d: c - d, de_full, b)
        s = tm(lambda a, dd: a + dd, dx, de)

        def err(a, dd, ss):
            z = ss - a
            return (a - (ss - z)) + (dd - z)

        e_new = tm(err, dx, de, s)
        return s, e_new

    combine = jax.jit(_two_sum_combine)

    if state is not None:
        x = (state[0], state[1])
    else:
        x = (u0, Tc0)
    e = jax.tree_util.tree_map(jax.numpy.zeros_like, x)
    prev_Tv = Tv0
    res = float("inf")
    it = 0
    for it in range(1, max_iter + 1):
        dx = F(x)                    # value-part step (with sources/BCs)
        de_full = F(e)               # homogeneous step arrives as F(e)
        nstep += 2
        x, e = combine(dx, de_full, b_aff)
        # reference-style Tv residual on the value part (cheap: reuse the
        # step's own Tv output requires a third application; instead fetch
        # every check_every via one extra plain step)
        if it % check_every == 0 or it == max_iter:
            u_r, Tc_r, Tv_r, res_dev = step_fn(x[0], x[1], prev_Tv)
            res = float(res_dev)
            prev_Tv = Tv_r
            if verbose:
                print(f"[pbte] comp iter {it} ({nstep} steps), "
                      f"residual = {res:.6e}")
            if callback is not None:
                callback(it, res)
            if res < tol:
                break
    # final Tv from one plain step at the compensated point
    u_f, Tc_f, Tv_f, res_dev = step_fn(x[0], x[1], prev_Tv)
    return x[0], x[1], Tv_f, float(res_dev), nstep




def correction_outer(step_fn, zero_state, d, tol=1e-4, max_iter=3000,
                     verbose=True, check_every=10, consume_d=False):
    """Solve the correction equation (I - A) e = d by the plain fixed
    point e' = F(e) + g with g = d - F(0) folded once (F affine).

    The iterate difference IS the linear residual: e' - e = d - (I - A) e,
    so convergence is monitored as ||e' - e|| / ||d|| at zero extra cost.
    Returns (e, n_step_applications, final_relres). `d` must be a device
    tree matching the solver's (u, Tc) state structure.

    Memory: the loop's live set is consts + g + e + F(e) + step internals —
    only TWO state trees beyond a plain solve (b is folded into g, the
    update donates its inputs). With consume_d=True, `d`'s buffers are
    DONATED into g (the caller's tree becomes invalid) — at flagship
    scale (u ~1.1 GB f32) that is one state tree less on the device."""
    import functools

    import jax
    import jax.numpy as jnp

    u0, Tc0, Tv0 = zero_state
    tm = jax.tree_util.tree_map

    def F(z):
        u, Tc, _, _ = step_fn(z[0], z[1], Tv0)
        return (u, Tc)

    b = F((u0, Tc0))
    nstep = 1
    dn = float(jnp.sqrt(tree_dot(d, d)))

    donate = (0, 1) if consume_d else (1,)
    g = jax.jit(
        lambda dd, bb: tm(lambda a, c: a - c, dd, bb),
        donate_argnums=donate,
    )(d, b)
    del b, d

    @functools.partial(jax.jit, donate_argnums=(0, 2))
    def upd(Fe, g, e):
        e_new = tm(lambda a, c: a + c, Fe, g)
        diff = tm(lambda x1, x2: x1 - x2, e_new, e)
        return e_new, tree_dot(diff, diff)

    e = (u0, Tc0)
    rel = float("inf")
    for it in range(1, max_iter + 1):
        Fe = F(e)
        nstep += 1
        e, rn2 = upd(Fe, g, e)
        if it % check_every == 0 or it == max_iter:
            rel = float(jnp.sqrt(rn2)) / max(dn, 1e-300)
            if verbose:
                print(f"[pbte] corr iter {it}, linear relres = "
                      f"{rel:.6e}")
            if rel < tol:
                break
    return e, nstep, rel


def correction_bicgstab(step_fn, zero_state, d, tol=1e-2, max_iter=400,
                        verbose=True, check_every=5, label="pbte",
                        consume_d=False):
    """Solve the correction equation (I - A) e = d with BiCGStab.

    Same linear system as `correction_outer`, Krylov instead of the plain
    fixed point: the operator is probed through the solver's affine step
    ((I - A) v = v - (F(v) - F(0))) and the RHS is the defect d directly.
    Measured f64 acceleration of the underlying recurrence is ~6x fewer
    step applications (tests/test_accel.py); in the refinement loop the
    inner tolerance only needs ~1e-2 (each round's contraction is capped
    by the f32 solver's own relative bias anyway), which can sit ABOVE an
    f32 Krylov stagnation floor set by rounded matmul operands — this is
    what makes Krylov usable in f32 where the direct accelerated solve to
    deep tolerances is not. Each round stagnates at the f32 affinity
    floor, which IS the per-round contraction the refinement loop needs.

    Memory: live set is consts + d + b + x + r + rhat + p + v + one
    transient (s/t) ~= 9 state trees — one MORE than `bicgstab_outer`
    (d must stay live for breakdown restarts). With consume_d=True, d is
    copied to HOST and its device buffers deleted (re-uploaded only on
    the rare breakdown restart) → 8 live trees. The 5 Krylov vectors +
    the s/t transient sit beside the step's OWN state-sized temporaries
    (rhs_base/t_old are (Km,BS,D,ne) each), so the peak is ~10 state
    trees + operators (~11 GB at the hex-16^3 flagship); where that does
    not fit, the correction path is the plain `correction_outer` (2
    extra trees, donated). A Schur
    reduction to macroscopic space was investigated and is structurally
    unavailable: the sweep rhs carries a FULL-RANK lagged term
    relax_w*(M u_old) (source_iteration.py rhs_base), so the affine map
    does not factor through the moment fields. Returns
    (e, n_step_applications, final_relres)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    u0, Tc0, Tv0 = zero_state
    tm = jax.tree_util.tree_map

    def F(z):
        u, Tc, _, _ = step_fn(z[0], z[1], Tv0)
        return (u, Tc)

    b = F((u0, Tc0))
    nmv = 1

    # same multi-device XLA:CPU collective-deadlock mitigation as
    # bicgstab_outer: serialize program dispatch fully
    _leaf = jax.tree_util.tree_leaves(b)[0]
    try:
        _ndev = len(_leaf.sharding.device_set)
    except AttributeError:  # pragma: no cover - non-Array leaf
        _ndev = 1
    serialize = jax.default_backend() == "cpu" and _ndev > 1
    if serialize:
        jax.block_until_ready(b)

    sub = jax.jit(lambda v, Fv, bb: tm(lambda a, c, e_: a - (c - e_),
                                       v, Fv, bb))
    diff = jax.jit(lambda a, c: tm(lambda x1, x2: x1 - x2, a, c))

    def Mop(v):
        nonlocal nmv
        nmv += 1
        out = sub(v, F(v), b)
        if serialize:
            jax.block_until_ready(out)
        return out

    stage_p, stage_s, stage_x = make_bicgstab_kernels()
    _copy = lambda tr: tm(lambda a: a.copy(), tr)
    if consume_d:
        d_host = tm(lambda a: np.asarray(a), d)
        dnorm = float(np.sqrt(sum(
            float((np.asarray(l, dtype=np.float64) ** 2).sum())
            for l in jax.tree_util.tree_leaves(d_host)
        )))
        for leaf in jax.tree_util.tree_leaves(d):
            if hasattr(leaf, "delete"):
                leaf.delete()
        del d
        fresh_d = lambda: tm(jnp.asarray, d_host)
    else:
        dnorm = float(jnp.sqrt(tree_dot(d, d)))
        fresh_d = lambda: _copy(d)
    x = tm(jnp.zeros_like, (u0, Tc0))
    r = fresh_d()       # r0 = d - (I-A)·0
    rhat = fresh_d()
    leaf0 = jax.tree_util.tree_leaves(Tc0)[0]
    one = jnp.asarray(1.0, dtype=leaf0.dtype)
    rho_prev = alpha = omega = one
    v = tm(jnp.zeros_like, r)
    p = tm(jnp.zeros_like, r)
    rel = float("inf")
    k = 0
    best = float("inf")
    stale = 0
    last_gain_nmv = nmv
    while nmv + 2 <= max_iter:
        rho, p = stage_p(r, rhat, p, v, rho_prev, alpha, omega)
        if serialize:
            jax.block_until_ready(p)
        v = Mop(p)
        alpha, s = stage_s(r, rhat, v, rho)
        if serialize:
            jax.block_until_ready(s)
        t = Mop(s)
        omega, x, r, rnorm2 = stage_x(x, p, s, t, alpha)
        if serialize:
            jax.block_until_ready(rnorm2)
        rho_prev = rho
        k += 1
        # fetch the (already computed) residual scalar EVERY iteration:
        # besides the stopping test it bounds the host's dispatch depth.
        # Without it the host dispatches check_every iterations ahead,
        # each pinning its generation of ~5 state trees, which multiplies
        # this loop's live set; one scalar per matvec pair costs nothing
        # measurable against two full-sweep matvecs.
        rn = float(rnorm2) ** 0.5
        rel = rn / max(dnorm, 1e-300)
        if k % check_every == 0 or nmv + 2 > max_iter:
            if verbose:
                print(f"[{label}] corr matvec {nmv}, linear relres = "
                      f"{rel:.6e}")
            if not np.isfinite(rel) or abs(float(rho)) < 1e-300:
                if nmv + 1 > max_iter:
                    break
                # breakdown: restart the recurrence at x (r = d - (I-A)x)
                r = diff(fresh_d(), Mop(x))
                if serialize:
                    jax.block_until_ready(r)
                rhat = _copy(r)
                rho_prev = alpha = omega = one
                v = tm(jnp.zeros_like, r)
                p = tm(jnp.zeros_like, r)
                if verbose:
                    print(f"[{label}] corr bicgstab restart (breakdown)")
                continue
            if rel < tol:
                break
            # cadence-independent stagnation guard (see bicgstab_outer)
            if rel < 0.9 * best:
                best, stale, last_gain_nmv = rel, 0, nmv
            else:
                stale += 1
                if stale >= 6 and nmv - last_gain_nmv >= 60:
                    if verbose:
                        print(f"[{label}] corr bicgstab stagnated at "
                              f"relres {rel:.3e}; stopping")
                    break
    return x, nmv, rel


def refined_solve(solver, step64_fn, tol=1e-7, max_iter=3000,
                  inner_tol=1e-4, inner_max_iter=3000, verbose=True,
                  check_every=10, state=None, inner="plain"):
    """ITERATIVE REFINEMENT: a route to a 1e-8 relative-L2 field with an
    f32 solver.

    The f32 fixed point carries a converged bias from the f32 rounding of
    the step's own outputs, amplified by ~1/(1-rho) (measured 1.83e-6 at
    hex 6^3 with exact dots — see compensated_outer's refutation: widening
    the STATE cannot remove it). Classic refinement does:

      1. converge x with the f32 solver (any precision tier);
      2. compute the DEFECT in float64:  d = F64(x) - x  — ONE step of an
         exact-arithmetic twin (`step64_fn`), the only f64 work;
      3. solve the correction (I - A) e = d with the same f32 solver
         (correction_outer) — e only needs ~1e-4 RELATIVE accuracy since
         |e| ~ 1e-6 |x|;
      4. combine x + e in float64 on host.

    Error after one round ~ |e| * max(inner_tol, f32 floor) ~ 1e-10 |x|,
    certified by re-evaluating the defect at the refined point:
    ||x_ref - x*|| <= ||d(x_ref)|| / (1 - rho).

    step64_fn(u64, Tc64, Tv64) -> (u', Tc', Tv', res) must be one step of
    a float64 twin of `solver` on the SAME problem with identical state
    tree structure/shapes (e.g. a dtype=float64 CPU SourceIterationSolver
    .step, in-process or via a subprocess wrapper). Returns a dict with
    the refined fields (float64) and the solve/correction diagnostics.

    inner: "plain" (correction_outer fixed point, lowest memory) or
    "krylov" (correction_bicgstab, ~3-6x fewer step applications
    measured, +1 state tree of device memory)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    tm = jax.tree_util.tree_map
    res = solver.solve(tol=tol, max_iter=max_iter, verbose=verbose,
                       check_every=check_every, state=state)
    x = (res.u, res.Tc)

    # ---- f64 defect: d = F64(x) - x ------------------------------------
    x64 = tm(lambda a: np.asarray(a).astype(np.float64), x)
    Tv64 = np.zeros_like(np.asarray(res.Tv), dtype=np.float64)
    u_p, Tc_p, _, _ = step64_fn(x64[0], x64[1], Tv64)
    d64 = (
        tm(lambda a, c: np.asarray(a, dtype=np.float64) - c, u_p, x64[0]),
        np.asarray(Tc_p, dtype=np.float64) - x64[1],
    )
    d_norm = float(np.sqrt(sum(
        float((np.asarray(l) ** 2).sum())
        for l in jax.tree_util.tree_leaves(d64)
    )))

    # ---- f32 correction solve AT x-SCALE ---------------------------------
    # The correction step F(e) - b evaluates the sweep at the ORIGINAL
    # field magnitudes (the rhs carries the full boundary sources), so its
    # f32 roundoff is x-scale (~6e-8 |x| per step) regardless of |e| — an
    # unscaled correction solve therefore floors at the SAME absolute bias
    # as the base solve (measured: 1.30e-6 vs base 1.83e-6 at hex 6^3).
    # Solving (I - A) w = s*d with the exact power-of-two scale
    # s ~ |x|/|d| puts w at x-scale, where the same absolute roundoff is
    # ~6e-8 RELATIVE — unscaling divides the amplified noise by s
    # (~1e-12 |x| absolute).
    x_norm = float(np.sqrt(sum(
        float((np.asarray(l, dtype=np.float64) ** 2).sum())
        for l in jax.tree_util.tree_leaves(x64)
    )))
    s_pow = 1.0
    if d_norm > 0 and x_norm > 0:
        s_pow = float(2.0 ** np.round(np.log2(x_norm / d_norm)))
    d32 = tm(
        lambda a: jnp.asarray(
            (np.asarray(a, dtype=np.float64) * s_pow).astype(
                solver_dtype(solver)
            )
        ),
        d64,
    )

    def step_fn(u_, Tc_, Tv_):
        return solver._step_plain(solver.consts, u_, Tc_, Tv_)

    corr = correction_bicgstab if inner == "krylov" else correction_outer
    e, nstep, relres = corr(
        step_fn, solver.initial_state(), d32, tol=inner_tol,
        max_iter=inner_max_iter, verbose=verbose, check_every=check_every,
        consume_d=True,
    )
    del d32

    # ---- combine in float64 (unscaling by the exact power of two) --------
    Tc_ref = x64[1] + np.asarray(e[1], dtype=np.float64) / s_pow
    u_ref = tm(
        lambda a, c: a + np.asarray(c, dtype=np.float64) / s_pow,
        x64[0], e[0],
    )
    return {
        "Tc_refined": Tc_ref,
        "u_refined": u_ref,
        "base_result": res,
        "defect_norm": d_norm,
        "correction_steps": nstep,
        "correction_relres": relres,
    }


def solver_dtype(solver):
    """numpy dtype of the solver state."""
    import numpy as np

    dt = solver.dtype
    return np.dtype(dt.dtype if hasattr(dt, "dtype") else dt)
