"""Source-iteration PBTE solver with batched wavefront sweeps (the hot path).

Accelerator redesign of pbte::PBTESolver (ref: src/PBTESolver.cpp:208-332).
The reference's inner loops — for each (direction, branch, band): visit
elements in upwind order, assemble a DOF-sized rhs, per-element dense LU
solve — become:

  vmap over direction-GROUPS (shared upwind DAG):       # <= 2^dim groups
      lax.scan over wavefront LEVELS:                   # O(ne^(1/dim)) steps
          one batched level step over
          (Km directions) x (BS bands) x (W elements):  # big batched GEMMs
            rhs   = a_bs * (M^T Tc_e) + b_bs * (M^T u_e)
                    - sum_f vg*min(s.n, 0) * (C_ef u_nbr | (C/Omega) Tbc If)
            u_e   = A_inv[k, bs, e] @ rhs
          scatter into u

Layout decisions:

1. SLOT-MAJOR ordinate storage: u is (G, Km, BS, D, ne_pad) where slot (g, k)
   holds direction plan.dirs_of_group[g][k] (padded slots carry zero weight in
   every reduction). No direction gather/scatter in the hot loop; the Km axis
   is the device-sharding axis ("ordinate data parallelism", SURVEY section 2.3).

2. LEVEL-CONTIGUOUS element ordering: within each group, elements are
   permuted into concatenated wavefront-level order (level l occupies columns
   [offset_l, offset_l + count_l), total exactly ne — no interspersed
   padding). Per-level operator access is a lax.dynamic_slice of static width
   W_max at the (clamped) level offset; slots outside the level compute
   garbage that the masked write-back discards (slots before the offset are
   already-final earlier-level values which the mask preserves; slots after
   belong to later levels and are overwritten by their own step). A
   contiguous slice streams the multi-GB A^-1 at copy speed, where an
   arbitrary-index gather on its minor axis would not. Only the per-level
   neighbor read remains a (small) gather.

3. ELEMENT-LAST device layout: operator tensors keep the element axis
   minor-most — (D, D, ne), (G, Km, BS, D, D, ne) — so the large ne axis, not
   the small D axis, is the contiguous one every per-level slice cuts.

4. Operator tensors travel as jit ARGUMENTS (self.consts pytree), never as
   captured closure constants (constants are baked into the lowered HLO —
   GBs shipped through compilation for production shapes).

5. A^-1 is precomputed on HOST in chunked batched float64 LAPACK (the
   CachePolicy::FullLU analog) and shipped element-last in level order;
   "per-iteration" recomputes it on device each sweep (the OnTheFly analog
   for memory-constrained shapes).

Operator (ref: src/PBTESolver.cpp:146-168), scaled by 1/dt_inv (exact
non-dimensionalization; keeps coefficients O(1) so f32 is stable):
    A~ = M + (vg/dt_inv) * G[k,e],
    G  = -sum_d s_d S_d + sum_f max(s.n_f, 0) * Mf,
    dt_inv = max invKn over all bands (ref: src/PBTESolver.cpp:39-47).

Semantics preserved exactly (SURVEY.md section 2.4): Gauss-Seidel in space
within a sweep (upwind neighbors live in strictly earlier levels), lagged Tc
between outer iterations, inflow factor 0.5*vg*(s.n-|s.n|) == vg*min(s.n,0),
residual on cell-average Tv.

Parity evidence: with face_mode="mfem-parity" assembly, the 2D demo
(unit-square-iso, p=1, 24 dirs, 2x20 bands, 101 iterations) reproduces the
reference's committed Tc_all.txt and coeff_all.txt byte-for-byte at %g
precision and T_slice.txt to 2.5e-15.

Simplex lattice meshes (the reference's production 6-tet cuboids and 2D
2-tri splits) are additionally merged into macro-cell SUPER ELEMENTS
(fem/supercell.py, the `supercell=` option): the intra-cell upwind
couplings move into the block-triangular transport factor (exact), the
macro adjacency is a verified box lattice, and this same ring machinery
runs on it with 2^dim octant groups, D' = gsz*D DOFs and a two-matmul
body — the path that runs the reference's FULL legacy production
configuration on one device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pbte.models import macroscopic
from pbte.sweep import planner


def _lattice_ring_tables(lat, plan, dirs_np, major_axis=None):
    """Per-group lattice slab tables for the SHIFT-STRUCTURED ring sweep.

    With wavefront level l = sum of sweep-transformed integer coordinates
    i'_d (i'_d = coord_d for positive sweep axes, n_d-1-coord_d for
    negative) and slab slot w = i'_p1 * n_p2 + i'_p2 over the plane axes,
    the upwind neighbor along every axis sits in the PREVIOUS level's slab
    at a static offset (0 for the major axis, n_p2 / 1 for the plane axes).
    The ring sweep's neighbor selection then needs no one-hot matmuls —
    those cost (W*nf_act)/D ~ 7-21x the useful coupling flops.

    Returns (tables (G, L, W), axis_faces (G, dim), shifts (dim,)) or None.
    tables[g, l, w] = element id (or -1 padding); axis_faces[g, j] = the
    inflow face slot of axis j for group g (the active-face order is BY
    AXIS, identical shift vector for every group); shifts[j] = slab offset
    of axis j's upwind neighbor within the previous level's slab.
    """
    dim = len(lat.dims)
    dims = np.asarray(lat.dims, dtype=np.int64)
    G = plan.num_groups
    ne = lat.coords.shape[0]
    L = int(dims.sum()) - dim + 1
    if L != plan.max_levels:
        return None
    # slab plane = all axes but the largest (minimizes W = prod(plane dims));
    # major_axis overrides (the spatial slab solver must partition along a
    # non-periodic axis)
    a0 = int(np.argmax(dims)) if major_axis is None else int(major_axis)
    plane = [d for d in range(dim) if d != a0]
    shifts = np.zeros(dim, dtype=np.int64)
    if dim == 3:
        W = int(dims[plane[0]] * dims[plane[1]])
        shifts[plane[0]] = int(dims[plane[1]])
        shifts[plane[1]] = 1
    elif dim == 2:
        W = int(dims[plane[0]])
        shifts[plane[0]] = 1
    else:
        return None
    tables = np.full((G, L, W), -1, dtype=np.int32)
    axis_faces = np.zeros((G, dim), dtype=np.int64)
    for g in range(G):
        rep = dirs_np[plan.dirs_of_group[g][0]]
        if np.abs(rep[:dim]).min() < 1e-14:
            return None  # axis-grazing direction: sign pattern ill-defined
        sgn = np.where(rep[:dim] > 0, 1, -1)
        ip = np.where(sgn[None, :] > 0, lat.coords, dims[None, :] - 1 - lat.coords)
        lev = ip.sum(axis=1)
        # the lattice leveling must BE the canonical longest-path leveling
        if not np.array_equal(lev, plan.level_of_elem[g]):
            return None
        if dim == 3:
            w = ip[:, plane[0]] * dims[plane[1]] + ip[:, plane[1]]
        else:
            w = ip[:, plane[0]]
        tables[g, lev, w] = np.arange(ne, dtype=np.int32)
        axis_faces[g] = np.where(sgn > 0, lat.face_minus, lat.face_plus)
    return tables, axis_faces, shifts


def _pick_level_segments(counts, max_segments=6):
    """Partition the level axis into <= max_segments contiguous segments,
    minimizing sum(len(seg) * max_width(seg)) — the columns actually touched
    per sweep. Exact DP; L is at most a few hundred."""
    L = counts.shape[1]
    maxw = counts.max(axis=0).astype(np.int64)  # width needed at each level
    INF = 1 << 60
    best = np.full((max_segments + 1, L + 1), INF, dtype=np.int64)
    cut = np.zeros((max_segments + 1, L + 1), dtype=np.int64)
    best[0, 0] = 0
    for m in range(1, max_segments + 1):
        for j in range(1, L + 1):
            mx = 0
            for i in range(j - 1, -1, -1):
                mx = max(mx, int(maxw[i]))
                cand = best[m - 1, i] + (j - i) * mx
                if cand < best[m, j]:
                    best[m, j] = cand
                    cut[m, j] = i
    m = int(np.argmin(best[:, L]))
    segs = []
    j = L
    for mm in range(m, 0, -1):
        i = int(cut[mm, j])
        segs.append((i, j, max(int(maxw[i:j].max()), 1)))
        j = i
    segs.reverse()
    return segs


def _fit_ring_window(lo, hi, i, j, W, quantum=128):
    """Fit an ALIGNED static window [o0, o0+Ws) over levels [i, j):
    o0 and Ws multiples of `quantum` (Ws capped at W-o0), covering every
    level's valid hull [lo_l, hi_l] AND (for i > 0) hull(i-1) — the first
    level of a segment reads its upwind values from the previous segment's
    final slab REWINDOWED into this frame, so carry coverage is a
    correctness requirement, not an optimization. The quantum keeps the
    segment count (one compiled scan body each) small and the window
    slices aligned; whether 128 is the right quantum on a GPU is open
    (flagship, NVIDIA H100 80GB HBM3 at 700 W: 22.4 ms/step windowed,
    26.4 with PBTE_RING_WINDOWS=0). Returns
    (o0, d=0, Ws); (0, 0, W) is the always-feasible full-width fallback
    (the d slot is kept so downstream code matches the historical affine
    form)."""
    lo_all = int(np.min(lo[max(i - 1, 0):j]))
    hi_all = int(np.max(hi[max(i - 1, 0):j]))
    o0 = (lo_all // quantum) * quantum
    Ws = -((o0 - 1 - hi_all) // quantum) * quantum  # ceil to the quantum
    if o0 + Ws > W:
        Ws = W - o0  # still covers the hull: hi_all <= W-1
    return (o0, 0, Ws)


def _pick_ring_windows(lo, hi, W, max_segments=8):
    """Partition the level axis into <= max_segments contiguous segments,
    each with an aligned hull window from _fit_ring_window, minimizing
    the total slot count sum(len(seg) * Ws). Exact DP over cut points (L is
    at most a few hundred); the carry-coverage constraint is inside the
    per-segment fit, so the DP naturally places cuts where consecutive
    hulls clear a 128-slot boundary. Returns
    [(l0, l1, o0, d, Ws), ...]."""
    L = len(lo)
    INF = 1 << 60
    fit = {}
    for i2 in range(L):
        for j2 in range(i2 + 1, L + 1):
            fit[(i2, j2)] = _fit_ring_window(lo, hi, i2, j2, W)
    best = np.full((max_segments + 1, L + 1), INF, dtype=np.int64)
    cut = np.zeros((max_segments + 1, L + 1), dtype=np.int64)
    best[0, 0] = 0
    for m in range(1, max_segments + 1):
        for j2 in range(1, L + 1):
            for i2 in range(j2 - 1, -1, -1):
                cand = best[m - 1, i2] + (j2 - i2) * fit[(i2, j2)][2]
                if cand < best[m, j2]:
                    best[m, j2] = cand
                    cut[m, j2] = i2
    m = int(np.argmin(best[:, L]))
    segs = []
    j2 = L
    for mm in range(m, 0, -1):
        i2 = int(cut[mm, j2])
        o0, d, Ws = fit[(i2, j2)]
        segs.append((i2, j2, o0, d, Ws))
        j2 = i2
    segs.reverse()
    return segs


def _memory_limits(budget):
    """Byte limits of the solver's memory policy on a device that lets the
    process allocate `budget` bytes. Each limit is a fixed share of the
    budget: the limit as first sized, over the 16 GB it was sized for."""
    return {
        # lattice and supercell ring state (with the bf16-state fallback)
        "ring_state": 0.75 * budget,
        # general-mesh ring: padded state and one-hot tables (auto), and
        # the one-hot tables an explicit sweep_mode="ring" may take
        "general_ring_state": 0.28125 * budget,
        "one_hot": 0.04375 * budget,
        "one_hot_forced": 0.125 * budget,
        # two in-flight f32 ring state buffers before bf16 state is chosen
        "auto_bf16_state": 0.6875 * budget,
        # hoisted scan-path rhs base and relaxation term
        "hoist_rhs": 0.125 * budget,
        # on-the-fly inverse working set before groups run sequentially
        "seq_groups": 0.375 * budget,
        # one ring state buffer before the step donates its input
        "donate": 0.34375 * budget,
    }


class SourceIterationSolver:
    """Build once per (mesh, angles, material, bcs) problem; jitted step."""

    def __init__(
        self,
        ops,  # fem.assembly.ElementOps
        quad,  # angular.quadrature.AngularQuad
        tables,  # material.nongray_smrt.PhononTables
        bc_temps: dict,  # boundary attr -> temperature deviation
        dirichlet_bcs: dict | None = None,  # attr -> prescribed incoming
        diffuse_bcs=None,  # iterable of attrs: legacy BC type 2 (Lambert
        # reflection — the incoming intensity is face-isotropic per band,
        # sized so the face's net energy flux per band is ZERO), applied as
        # a LAGGED coupling like periodic wraps. Both reference trees parse
        # type 2 but reject it at solve time; this implements it.
        specular_bcs=None,  # iterable of attrs: legacy BC type 3 (mirror
        # reflection u_in(s) = own trace at s' = s - 2(s.n)n, lagged).
        # Requires axis-aligned faces and a mirror-symmetric quadrature
        # about those axes (validated; the gauss azimuth rule is symmetric
        # about y only — use the uniform rule for x-normal specular faces).
        # intensity (legacy BC type 7). The reference wires FluxMat for type
        # 7 (Reference Project/include/PolyFem/PolyIntegral.hpp:299-321) but
        # its solvers reject it at solve time and the analytic-profile
        # quadrature is commented out; here the completed semantics: inflow
        # through a marked face reads the prescribed value g (constant per
        # attr) instead of the thermalized equilibrium, i.e.
        # rhs += -vg*cin * g * int_F phi_i  (no heat_cap/omega factor).
        dtype=None,
        cache_policy: str = "full",  # "full" | "per-iteration"
        require_bcs: bool = True,
        dir_sharding=None,  # optional jax.sharding.NamedSharding for the Km axis
        scan_unroll: int = 1,  # unroll factor for the level scan
        matmul_precision: str | None = None,  # e.g. "highest" (see below)
        sweep_mode: str = "auto",  # "auto" | "scan" | "ring" (see below)
        use_lattice: bool = True,  # shift-structured ring on Cartesian
        # lattice meshes (False forces the general one-hot selection; kept
        # selectable so both ring variants stay testable on every mesh)
        supercell: str = "auto",  # "auto" | "on" | "off": merge simplex
        # lattice macro cells (6-tet / 2-tri splits) into block super
        # elements and ring-sweep the macro lattice (fem/supercell.py).
        # "auto" engages for ne >= 512 when detection verifies the
        # structure; "on" forces the attempt on any size (tests); "off"
        # keeps the fine-mesh paths.
        supercell_box: int = -1,  # BOX merge (fem/supercell.detect_box):
        # group factor^dim hex/quad elements into one block super element,
        # raising the sweep's arithmetic intensity gsz-fold at gsz times the
        # dense-apply flops. The step's bytes are the mandatory state
        # streams, which the merge leaves unchanged, so it measured slower
        # than the fine ring where it was first built. -1 = auto (resolves
        # OFF), 0 = off, n >= 2 = force factor n (exact semantics,
        # iterate-identical — tests/test_supercell.py). Env PBTE_SUPER_BOX
        # overrides.
    ):
        import jax
        import jax.numpy as jnp

        from pbte.device import memory_budget

        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        lim = _memory_limits(memory_budget())
        np_dtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
        if cache_policy == "per-iteration":
            cache_policy = "on-the-fly"  # back-compat alias
        if cache_policy not in ("full", "on-the-fly", "eigen"):
            raise ValueError(f"unknown cache_policy: {cache_policy}")
        if sweep_mode not in ("auto", "scan", "ring"):
            raise ValueError(f"unknown sweep_mode: {sweep_mode}")
        self.cache_policy = cache_policy
        self.scan_unroll = scan_unroll
        # Matmul precision of the f32 step (f64 runs every dot in f64).
        # None/"default" lets XLA's GPU backend run f32 dots on TF32 tensor
        # cores, and the staged lattice ring feeds its transport dots bf16
        # operands (see _ring_stage_bf16). "highest" runs every f32 dot in
        # full f32. "high" is XLA's middle tier. "selective" raises ONLY the
        # ring transport contractions (factor apply + neighbor coupling) to
        # HIGHEST and leaves the small closure einsums at default — the
        # per-step rounding of the state recurrence is what the fixed point
        # amplifies by ~1/(1-rho). Measured on the hex 16^3 p=2 flagship,
        # relative L2 distance of Tc from an f64 run after 11 steps (NVIDIA
        # H100 80GB HBM3, 700 W): default 3.3e-4 (1.8e-4 without bf16
        # staging), selective 2.1e-4, high and highest 2.2e-7 — XLA runs
        # `high` as full f32 on this card — at 22.4 ms/step for default and
        # 26.9 for high, highest and selective.
        self._sel_hi = matmul_precision == "selective"
        if self._sel_hi:
            matmul_precision = None
        self.matmul_precision = matmul_precision

        self.ne = ne = ops.num_elements
        self.D = D = ops.ndof
        self.nf = nf = ops.faces_per_elem
        self.dim = ops.dim
        self.K = quad.num_directions
        self.BS = BS = tables.num_branches * tables.num_spectral
        self.num_branches = tables.num_branches
        self.omega = quad.total_weight
        self.quad = quad

        # flat band tables (float64 host math)
        inv_kn = tables.flat("inv_kn").astype(np.float64)
        vg = tables.flat("vg").astype(np.float64)
        heat_cap = tables.flat("heat_cap").astype(np.float64)
        self.dt_inv = float(inv_kn.max())

        # ---- canonical face ordering (ring-mode enabler) -------------------
        # Sorting each element's local faces by outward normal collapses the
        # geometry-class count on translation-invariant meshes (hex 6 -> 1,
        # quad 3 -> 1, 6-tet 12 -> 6): the per-element transport operator A
        # then repeats across elements and the sweep's dense solves become a
        # few class-batched matmuls (see sweep_mode="ring" below). The
        # permutation is applied consistently to every per-face table, so
        # physics is identical up to float summation order — gated to large
        # problems so tiny golden-parity demos keep bitwise legacy behavior.
        from pbte.fem import assembly as _assembly

        self._canonical_faces = False
        self._cls_cache = None  # element classes of the (final) ops
        if sweep_mode in ("auto", "ring") and ne >= 512:
            # the pre-canonical count is only COMPARED, so skip the noise
            # merge there (it costs an (ncls, cols) representative pass;
            # fine counts are an upper bound on both sides and canonical
            # ordering strictly removes slot-order splits)
            cls0 = _assembly.element_classes(ops, merge=False)
            ops_c = _assembly.permute_faces(
                ops, _assembly.canonical_face_perm(ops)
            )
            cls1 = _assembly.element_classes(ops_c)
            if cls1.max() < cls0.max():
                ops = ops_c
                self._canonical_faces = True
                self._cls_cache = cls1
            else:
                self._cls_cache = _assembly.element_classes(ops)

        # Boundary sanity: the serial reference asserts every boundary face has
        # an isothermal entry (ref: src/PBTESolver.cpp:286); Dirichlet
        # (type 7) attrs satisfy the check too.
        dirichlet_bcs = dirichlet_bcs or {}
        self.has_dirichlet = bool(dirichlet_bcs)
        diffuse_bcs = sorted(int(a) for a in (diffuse_bcs or ()))
        specular_bcs = sorted(int(a) for a in (specular_bcs or ()))
        self._dif_on = bool(diffuse_bcs)
        self._spc_on = bool(specular_bcs)
        bdry_attrs = set(int(a) for a in np.unique(
            ops.face_attr[(ops.neighbor < 0) & ops.face_valid]
        ))
        missing = (
            bdry_attrs
            - set(int(k) for k in bc_temps)
            - set(int(k) for k in dirichlet_bcs)
            - set(diffuse_bcs)
            - set(specular_bcs)
        )
        if missing and require_bcs:
            raise ValueError(
                f"boundary attributes without isothermal BC: {sorted(missing)}"
            )

        # ---- supercell merge: simplex lattices as block box lattices --------
        # The 6-tet (3D) / 2-tri (2D) splits of Cartesian lattices levelize
        # into many ragged direction groups on the fine mesh — the scan
        # path's worst regime (one-hot selection, ~3x slot padding and a
        # memory footprint that grows with it). Merging each macro cell into
        # ONE super element
        # with gsz*D DOFs (fem/supercell.py) restores the exact box-lattice
        # structure: 2^dim octant groups, zero slot padding on symmetric
        # quadratures, unit upwind gap, and the shift-structured ring with
        # (1+dim)*gsz*D-wide folded contractions. The block solve is exact
        # (intra-cell upwind couplings move into the block-triangular
        # A_super), so semantics match the fine-mesh sweep to roundoff.
        self._super = None
        if supercell not in ("auto", "on", "off"):
            raise ValueError(f"unknown supercell={supercell!r}")
        cls_sc = self._cls_cache
        env_box = os.environ.get("PBTE_SUPER_BOX", "")
        box_factor = int(env_box) if env_box else int(supercell_box)
        if supercell == "on" and cls_sc is None:
            # forced mode on small meshes: canonicalize + classify here
            # (the ne >= 512 gate above skipped it)
            ops = _assembly.permute_faces(
                ops, _assembly.canonical_face_perm(ops)
            )
            cls_sc = _assembly.element_classes(ops)
            self._cls_cache = cls_sc
        if (
            supercell != "off"
            and sweep_mode in ("auto", "ring")
            and use_lattice
            and not dirichlet_bcs
            and not (diffuse_bcs or specular_bcs)
            and not ops.periodic.any()
            # axis-grazing directions (e.g. the 3D polar=1 in-plane rule)
            # make the octant sign pattern ill-defined — the lattice ring
            # rejects them, so the merge must not engage (the scan path
            # handles grazing fine on the raw ops)
            and float(
                np.abs(quad.directions[:, : ops.dim]).min()
            ) > 1e-14
        ):
            from pbte.fem import supercell as _supercell

            sc = None
            if cls_sc is not None and 2 <= int(cls_sc.max()) + 1 <= 8:
                sc = _supercell.detect(ops, cls_sc)
            if sc is None and box_factor != 0:
                # BOX merge of an already-Cartesian lattice. Auto resolves
                # OFF (see the supercell_box parameter). Kept as an explicit
                # lever (exact semantics, iterate-identical).
                bf = 0 if box_factor < 0 else box_factor
                if bf >= 2:
                    if self._cls_cache is None:
                        ops_cb = _assembly.permute_faces(
                            ops, _assembly.canonical_face_perm(ops)
                        )
                        sc = _supercell.detect_box(ops_cb, bf)
                        if sc is not None:
                            ops = ops_cb
                    else:
                        sc = _supercell.detect_box(ops, bf)
            if sc is not None and _supercell.verify_acyclic(
                sc, quad.directions
            ):
                # affordability mirror of the lattice-ring gate below (the
                # scan path cannot run on super ops — intra couplings live
                # only in the ring factor build)
                dims_sc = np.sort(np.asarray(sc.lat_dims, dtype=np.int64))
                L_sc = int(dims_sc.sum()) - len(dims_sc) + 1
                W_sc = int(np.prod(dims_sc[:-1]))
                state_sc = (
                    (self.K + 2 ** self.dim) * BS * sc.Dp * L_sc * W_sc
                    * np.dtype(np_dtype).itemsize
                )
                # affordability mirrors the ring gate PLUS the auto bf16-
                # state + donation policy (one bf16 buffer must fit next to
                # the factors)
                if sweep_mode == "ring" or state_sc <= lim["ring_state"]:
                    self._super = sc
                    ops = sc.super_ops
                    self.ne = ne = ops.num_elements
                    self.D = D = ops.ndof
                    self.nf = nf = ops.faces_per_elem
                    self._cls_cache = np.zeros(ne, dtype=np.int64)
        # fine-element count for Tv/residual semantics (the reference's
        # residual is over per-ELEMENT cell averages,
        # ref: src/MacroscopicQuantities.cpp:130-166)
        self.ne_tv = self._super.ne_fine if self._super else ne

        bc_T = np.zeros((ne, nf))
        for attr, T in bc_temps.items():
            bc_T[ops.face_attr == int(attr)] = float(T)
        # Dirichlet face integrals: g * int_F phi_i (constant g per attr);
        # dval keeps the scalar g per face for the class-compressed stream
        # mode (the face integral is then rebuilt from the class cache)
        dvec = np.zeros((ne, nf, D))
        dval = np.zeros((ne, nf))
        for attr, gval in dirichlet_bcs.items():
            sel = ops.face_attr == int(attr)
            dvec[sel] = float(gval) * ops.face_int[sel]
            dval[sel] = float(gval)

        # ---- sweep plan, slot-major (G, Km) layout -------------------------
        # periodic faces are EXCLUDED from the upwind DAG (they would close
        # cycles); their coupling is applied lagged from the previous outer
        # iterate below — mirroring how the reference orders before pairing
        # (Reference Project/include/SpatialMesh/SpatialMesh.hpp:272-276)
        self.has_periodic = bool(ops.periodic.any())
        sweep_nbr = ops.sweep_neighbor
        plan = planner.build_plan(sweep_nbr, ops.normals, quad.directions)
        self.plan = plan
        G = plan.num_groups
        Km = max(len(d) for d in plan.dirs_of_group)
        # dir_sharding spec: P(dir) shards the Km slot axis; P(dir, band)
        # additionally shards the spectral-band axis — lifting the ndev <= Km
        # ceiling: with Km x BS sharded, useful devices
        # scale to Km * BS. Both axes pad to their shard counts; padded
        # bands carry zero tables and are exactly inert.
        n_band_shards = 1
        n_dir_shards = 1
        if dir_sharding is not None:
            spec = list(dir_sharding.spec)
            n_dir_shards = (
                int(dir_sharding.mesh.shape[spec[0]])
                if len(spec) > 0 and spec[0] is not None else 1
            )
            if len(spec) > 1 and spec[1] is not None:
                n_band_shards = int(dir_sharding.mesh.shape[spec[1]])
            Km = -(-Km // n_dir_shards) * n_dir_shards
        if n_band_shards > 1:
            BS_pad = -(-BS // n_band_shards) * n_band_shards
            if BS_pad != BS:
                pad = BS_pad - BS
                inv_kn = np.concatenate([inv_kn, np.zeros(pad)])
                vg = np.concatenate([vg, np.zeros(pad)])
                heat_cap = np.concatenate([heat_cap, np.zeros(pad)])
                self.BS = BS = BS_pad
        self.BS_orig = tables.num_branches * tables.num_spectral
        dirs_pad = np.full((G, Km), -1, dtype=np.int64)
        for g, d in enumerate(plan.dirs_of_group):
            dirs_pad[g, : len(d)] = d
        self.dirs_pad = dirs_pad  # slot (g,k) -> global dir or -1
        self.G, self.Km = G, Km
        dir_valid = dirs_pad >= 0
        dirs_np = quad.directions[:, : self.dim]
        dirs_safe = np.where(dir_valid, dirs_pad, 0)

        # ring-mode Km BUCKETS: direction-group sizes are uneven (hex
        # flagship octants: [10,10,10,10,6,6,6,6] from the Gauss azimuth),
        # and one uniform vmap pads every group to the max — 25% pure waste.
        # Groups sharing the same (shard-rounded) slot count run in their
        # own vmap/scan with exactly that many slots.
        sizes = np.array([len(d) for d in plan.dirs_of_group])
        km_req = np.maximum(-(-sizes // n_dir_shards) * n_dir_shards, 1)
        self._ring_buckets = [
            (np.flatnonzero(km_req == kv), int(kv))
            for kv in sorted({int(x) for x in km_req}, reverse=True)
        ]

        # ---- level-ordered element layout per group --------------------------
        # Compact mode (default): perm[g] concatenates level member lists
        # (length exactly ne); level l occupies [offsets[g,l], +counts[g,l]).
        # Padded mode (the ring sweep): level l occupies the fixed slab
        # [l*W, (l+1)*W) with -1 padding; padded slots carry zero weights
        # everywhere.
        self.L = L = plan.max_levels
        self.W = W = min(plan.max_width, ne)

        # ---- sweep_mode="ring" decision ------------------------------------
        # The ring sweep replaces the compact level-window scan with a padded
        # (L, W) slab layout where each level emits its solution slab (scan
        # ys) and upwind neighbor values come from a ring of the previous H
        # slabs via ONE-HOT matmuls — eliminating the two per-level costs of
        # the scan path: the O(carry) dynamic-update-slice copy and the
        # minor-axis neighbor gather. Requires small geometry-class counts
        # (class-batched dense A^-1 apply) and a small upwind level gap H.
        self.sweep_mode = "scan"
        self.ncls_ring = 0
        self._ring_fold = False
        self._ring_ccpl = False
        self._ring_ccpl_arr = None
        self._ring_lattice = False
        ring_want = sweep_mode in ("auto", "ring")
        if ring_want:
            cls_r = (
                self._cls_cache if self._cls_cache is not None
                else _assembly.element_classes(ops)
            )
            ncls_r = int(cls_r.max()) + 1
            itemsize = np.dtype(np_dtype).itemsize
            # ---- lattice shift structure (the no-one-hot fast path) -------
            lat_tabs = None
            if use_lattice:
                lat = planner.detect_lattice(sweep_nbr, ops.normals)
                if lat is not None:
                    lt = _lattice_ring_tables(lat, plan, dirs_np)
                    if lt is not None:
                        lat_tabs, lat_axis_faces, lat_shifts = lt
            if lat_tabs is not None:
                H_r = 1  # lattice levelings have unit upwind gap by
                # construction (each axis decrement drops the level by 1)
                W_lat = lat_tabs.shape[2]
                oh_bytes = 0
                state_bytes = (sum(sizes) + G) * BS * D * L * W_lat * itemsize
                # budget includes the auto bf16-state + donation fallback
                # (one padded bf16 buffer; see the auto memory policy below)
                ok = ncls_r <= 8 and state_bytes <= lim["ring_state"]
                if sweep_mode == "ring":
                    ok = True
            else:
                # level index of each element per group
                lev_of = np.zeros((G, ne), dtype=np.int32)
                for g in range(G):
                    for l in range(L):
                        row = plan.levels[g, l]
                        lev_of[g, row[row >= 0]] = l
                nbr_s = np.where(sweep_nbr >= 0, sweep_nbr, 0)
                gaps = lev_of[:, :, None] - lev_of[:, nbr_s]  # (G, ne, nf)
                gaps = np.where(sweep_nbr[None] >= 0, gaps, 0)
                H_r = max(1, int(gaps.max()))
                oh_bytes = G * L * (H_r * W) * (nf * W) * 4
                # padded slab state (the ring's u) — two live copies in
                # flight with donation; must fit HBM next to the consts
                state_bytes = (
                    sum(sizes) + G  # slots incl. worst-case bucket padding
                ) * BS * D * L * W * itemsize
                # auto: heuristics for when ring beats the compact scan
                # (slabs reasonably full, small class count / ring depth,
                # bounded one-hot memory). Explicit "ring" overrides the
                # performance heuristics; only truly unaffordable memory
                # blocks it.
                ok = (
                    ncls_r <= 8 and H_r <= 4 and W >= 64
                    and oh_bytes <= lim["one_hot"]
                    and state_bytes <= lim["general_ring_state"]
                )
                if sweep_mode == "ring":
                    if oh_bytes > lim["one_hot_forced"]:
                        raise ValueError(
                            f"sweep_mode='ring' infeasible: one-hot tables "
                            f"need {oh_bytes/1e9:.1f}GB (ncls={ncls_r}, "
                            f"H={H_r}, W={W})"
                        )
                    ok = True
            if ok:
                self.sweep_mode = "ring"
                if lat_tabs is not None:
                    self._ring_lattice = True
                    self._lat_tables = lat_tabs
                    self._lat_axis_faces = lat_axis_faces
                    self._ring_shift_vals = tuple(int(s) for s in lat_shifts)
                    self.W = W = W_lat
                self.ncls_ring = ncls_r
                self._ring_cls = cls_r
                self._ring_H = H_r
                self._ring_ccpl_arr = (
                    _assembly.class_coupling(ops, cls_r) if ncls_r == 1
                    else None
                )
                self._ring_ccpl = self._ring_ccpl_arr is not None
                # per-class M^-T: the ring carries the mass-transformed
                # state v = M^T u, so every coupling that reads a neighbor
                # value gets a trailing M_{neighbor}^-T fold
                reps_r = np.array(
                    [int(np.flatnonzero(cls_r == c)[0])
                     for c in range(ncls_r)]
                )
                self._ring_invMT_cls = np.linalg.inv(
                    np.swapaxes(ops.mass[reps_r], -1, -2)
                )  # (ncls, D, D)

        if self._super is not None and self.sweep_mode != "ring":
            raise ValueError(
                "supercell merge engaged but the ring sweep was rejected "
                "(axis-grazing quadrature direction or leveling mismatch); "
                "pass supercell='off' to use the fine-mesh scan path"
            )

        # ---- bf16 operand staging for the lattice ring (default ON) --------
        # The per-level xcat staging buffer (and the ring carry it is built
        # from) is materialized bf16, halving the step's dominant staging
        # traffic. This is NOT free on a GPU: XLA's default f32 dot is TF32
        # (10-bit mantissa), so bf16 operands (7-bit) add rounding the dot
        # would not. Products are still accumulated in f32 and the iteration
        # stays deterministic, so residual convergence is unaffected; the
        # cost is field bias. On the flagship (NVIDIA H100 80GB HBM3, 700 W)
        # staging takes the f32 step from 25.1 to 22.4 ms/step and the
        # relative L2 distance of Tc from f64 after 11 steps from 1.8e-4 to
        # 3.3e-4. Default ON (ROADMAP 1.4 decides the default);
        # PBTE_RING_BF16=0 disables.
        self._ring_stage_bf16 = (
            self.sweep_mode == "ring"
            and self._ring_lattice
            and self._ring_ccpl
            and np_dtype == np.float32
            and matmul_precision in (None, "default")
            and not self._sel_hi
            and os.environ.get("PBTE_RING_BF16", "") != "0"
        )

        # ---- bf16 STATE storage (opt-in, PBTE_RING_STATE_BF16=1) ------------
        # One step further than operand staging: the carried solution state
        # v = M^T u itself (the scan ys and the per-bucket slabs between
        # outer iterations) is stored bf16 — halving the two state-sized
        # streams the staging flag cannot touch (the ys write at the end of
        # every level and the v_l read feeding the rhs). Numerically this
        # adds ONE bf16 rounding of v between iterations on top of staging:
        # the rhs built from v_l is already rounded to bf16 inside xcat, so
        # the only new error is the relax_w*v_l product being computed from
        # a pre-rounded v. Gated on _ring_stage_bf16 (default precision
        # only). Output precision: Tc/Tv come from the in-scan f32 macro
        # partials and are unaffected; u-derived outputs (heat_flux,
        # u_by_direction) carry bf16 resolution.
        self._ring_state_bf16 = (
            self._ring_stage_bf16
            and os.environ.get("PBTE_RING_STATE_BF16", "") == "1"
        )

        # ---- hull-windowed lattice ring -------------------------------------
        # The lattice slab pads every level to the full plane (W = n1*n2);
        # the diagonal wavefront's valid hull is much narrower near the
        # sweep's entry/exit corners (flagship 16^3: 4096 valid slots of
        # L*W = 11776, 2.9x padding). Every per-level cost (dots, shift
        # staging, ys writes, const slicing) is slot-proportional, so
        # windowing levels to per-segment aligned hull windows (see
        # _fit_ring_window) cuts the step's work to the slots kept
        # (flagship: 9856 slots = 16% off). Restricted to the single-class
        # lattice path (H=1, no lagged couplings — periodic wraps and
        # reflective BCs scatter at full-slab (level, slot) pairs);
        # PBTE_RING_WINDOWS=0 disables for A/B.
        self._ring_windowed = False
        self._ring_segs = None
        if (
            self.sweep_mode == "ring"
            and self._ring_lattice
            and self._ring_ccpl
            and self._ring_H == 1
            and not self.has_periodic
            and not (self._dif_on or self._spc_on)
            and os.environ.get("PBTE_RING_WINDOWS", "") != "0"
        ):
            vmask_all = self._lat_tables >= 0  # (G, L, W)
            # union hull across groups (groups of a box lattice share the
            # same hull by symmetry; the union stays correct regardless)
            vm = vmask_all.any(axis=0)
            win_lo = np.argmax(vm, axis=1)
            win_hi = vm.shape[1] - 1 - np.argmax(vm[:, ::-1], axis=1)
            # PBTE_RING_MAX_SEGS caps the hull-window segment count — each
            # segment compiles its own scan body, so fewer segments trade
            # some step time for proportionally less cold-compile work
            segs_w = _pick_ring_windows(
                win_lo, win_hi, self.W,
                max_segments=int(os.environ.get("PBTE_RING_MAX_SEGS", 8)),
            )
            slot_tot = sum((l1 - l0) * Ws for l0, l1, _, _, Ws in segs_w)
            if slot_tot < 0.95 * L * self.W:
                self._ring_windowed = True
                self._ring_segs = segs_w

        # ---- WD layout for the supercell ring --------------------------------
        # The macro plane W is tiny on production tet cuboids (5^3 -> W=25)
        # and is the minor axis of every ring operand. The WD layout puts
        # D' = gsz*D minor instead: state (L, G, Km, BS, W, D'), per-(k,b)
        # solve (W, J) @ (J, D'). Scope: supercell two-matmul ring (no
        # periodic/reflective/Dirichlet closures there by construction).
        # Hull windows are mutually exclusive with it (their quantum is
        # W-based). It measured slower than the W-minor layout where it was
        # first built (operand relayouts around the stacked coupling GEMM
        # ate the gain), so it stays OPT-IN (PBTE_SUPER_WD=1) until an
        # on-device A/B on this card decides it (ROADMAP 3.2).
        self._ring_wd = (
            self.sweep_mode == "ring"
            and self._super is not None
            and os.environ.get("PBTE_SUPER_FOLD", "") != "1"
            and os.environ.get("PBTE_SUPER_WD", "") == "1"
        )
        if self._ring_wd:
            self._ring_windowed = False
            self._ring_segs = None

        # ---- auto memory policy for the ring state -------------------------
        # When two in-flight f32 state buffers would take more than their
        # share of device memory, store the state bf16 (one extra rounding
        # of the carried v; see _ring_state_bf16 above) and donate the input
        # buffer. Explicit PBTE_RING_STATE_BF16=0 keeps f32.
        self._auto_mem = False
        if (
            self.sweep_mode == "ring"
            and not self._ring_wd
            and not self._ring_windowed
            and self._ring_stage_bf16
            and not self._ring_state_bf16
            and os.environ.get("PBTE_RING_STATE_BF16", "") != "0"
        ):
            state2 = (
                2 * (sum(sizes) + G) * BS * D * L * self.W
                * np.dtype(np_dtype).itemsize
            )
            if state2 > lim["auto_bf16_state"]:
                self._ring_state_bf16 = True
                self._auto_mem = True

        # scan-path rhs hoisting: precomputing the (Km, BS, D, ne) rhs base
        # and relaxation term for all G groups costs ~2 state-sized
        # temporaries under the vmap (the legacy 16x24-angle tet shape has
        # 24 groups x 47 slots). Assemble per level window instead when the
        # hoisted bytes exceed their share of device memory. The
        # periodic path scatters into the hoisted base, so it forces
        # hoisting (periodic problems are comparatively small).
        hoist_bytes = (
            2 * G * Km * BS * D * ne * np.dtype(np_dtype).itemsize
        )
        self._hoist_rhs = (
            self.has_periodic or self._dif_on or self._spc_on
            or hoist_bytes <= lim["hoist_rhs"]
        )

        self.padded = self.sweep_mode == "ring"
        if self.padded:
            W = self.W  # lattice mode widened the slab to the plane size
            levels_src = (
                self._lat_tables if self._ring_lattice else plan.levels
            )
            self.ne_pad = ne_pad = L * W
            perm = levels_src.reshape(G, ne_pad).astype(np.int64)  # -1 padded
            counts = np.zeros((G, L), dtype=np.int32)
            offsets = np.tile(np.arange(L, dtype=np.int32) * W, (G, 1))
            for g in range(G):
                counts[g] = (levels_src[g] >= 0).sum(axis=1)
        else:
            self.ne_pad = ne_pad = ne  # compact: no interspersed padding
            perm = np.empty((G, ne), dtype=np.int64)
            counts = np.zeros((G, L), dtype=np.int32)
            offsets = np.zeros((G, L), dtype=np.int32)
            for g in range(G):
                pos = 0
                for l in range(L):
                    row = plan.levels[g, l]
                    elems = row[row >= 0]
                    counts[g, l] = len(elems)
                    offsets[g, l] = pos
                    perm[g, pos : pos + len(elems)] = elems
                    pos += len(elems)
                assert pos == ne
        pos_valid = perm >= 0  # (G, ne_pad)
        perm_safe = np.where(pos_valid, perm, 0)
        # inverse: position of global element e in group-g order
        pos_of_elem = np.zeros((G, ne), dtype=np.int32)
        for g in range(G):
            pos_of_elem[g, perm_safe[g][pos_valid[g]]] = np.flatnonzero(pos_valid[g])
        self._perm = perm
        self._offsets = offsets
        self._counts = counts
        self._pos_valid = pos_valid
        # Width segmentation of the level axis (compact mode): level widths
        # are ~unimodal (BFS wavefronts), so a few contiguous segments with
        # per-segment static slice widths cut the masked-window compute and
        # operator-streaming waste of a single max-width window (flagship hex
        # 6^3: total columns touched 432 -> 272; unstructured tets ~45%
        # padding shrink similarly).
        if self.padded:
            self.segments = [(0, L, W)]
        else:
            self.segments = _pick_level_segments(counts)

        # ---- geometry classes (translation-invariant meshes) ----------------
        # detected on the global element set; used by the eigen and full
        # factor caches below
        from pbte.fem import assembly as _assembly

        self._cls = None
        self.ncls = 0
        if cache_policy in ("eigen", "full") and not self.padded:
            cls = (
                self._cls_cache if self._cls_cache is not None
                else _assembly.element_classes(ops)
            )
            ncls = int(cls.max()) + 1
            if ncls <= 64 and ncls * 4 <= ne:
                self._cls = cls
                self.ncls = ncls
                self._cls_reps = np.array(
                    [int(np.flatnonzero(cls == c)[0]) for c in range(ncls)]
                )

        # ---- class-compressed operator streams (opt-in, scan path) ---------
        # The per-element mass/coupling/face-integral streams are replicated
        # per direction group (gperm below): coupling alone is G*nf*D^2*ne
        # floats — ~10 GB at a refined-tet production growth shape (G=34,
        # ne=48k, p=3). When every element of a class shares these tensors
        # (translation-invariant meshes; VERIFIED below, not assumed), the
        # level body instead rebuilds each window from an (ncls, ...) cache
        # with the same tiny one-hot matmul the class-full factor cache
        # uses, and the G-replicated streams ship as 1-wide dummies.
        # Scope: the class-full factor policy (supplies the one-hot), no
        # periodic/reflective couplings (those scatter into the hoisted rhs
        # base, which this mode drops — the point is a window-local working
        # set). Opt-in via PBTE_SCAN_CLASS_OPS=1 until measured on device.
        self._scan_cls_ops = False
        if (
            self._cls is not None
            and cache_policy == "full"
            and not self.has_periodic
            and not (self._dif_on or self._spc_on)
            and os.environ.get("PBTE_SCAN_CLASS_OPS", "") == "1"
        ):
            cpl_cls_s = _assembly.class_coupling(ops, self._cls)
            ok_cls = cpl_cls_s is not None
            if ok_cls:
                for arr in (ops.mass, ops.face_int):
                    ref = arr[self._cls_reps][self._cls]
                    scale = max(float(np.abs(arr).max()), 1e-300)
                    if float(np.abs(arr - ref).max()) > 1e-10 * scale:
                        ok_cls = False
                        break
            if ok_cls:
                self._scan_cls_ops = True
                self._cls_massT = np.swapaxes(
                    ops.mass[self._cls_reps], -1, -2
                )  # (ncls, D, D)
                self._cls_cpl = cpl_cls_s  # (ncls, nf, D, D)
                self._cls_fint = ops.face_int[self._cls_reps]  # (ncls,nf,D)
                # the whole point is a window-local working set: no
                # (G, Km, BS, D, ne) hoisted rhs/relax temporaries
                self._hoist_rhs = False

        # neighbor positions per group: (G, nf, ne_pad), -1 boundary/padding
        # (from the periodic-masked table: in-sweep gathers must never read a
        # periodic partner — those arrive lagged through the rhs base)
        nbr = sweep_nbr  # (ne, nf)
        nbr_g = nbr[perm_safe]  # (G, ne_pad, nf)
        nbr_pos = np.where(
            (nbr_g >= 0) & pos_valid[..., None],
            np.take_along_axis(
                pos_of_elem, np.clip(nbr_g, 0, None).reshape(G, -1), axis=1
            ).reshape(G, ne_pad, nf),
            -1,
        )
        nbr_pos = np.swapaxes(nbr_pos, 1, 2)  # (G, nf, ne_pad)

        # ---- lagged periodic couplings: compact per-group slot lists -------
        # (face f of the element at group position `pos` wraps to the element
        # at group position `src`); applied once per outer step against the
        # previous iterate, so size-P tables instead of (nf, ne) masks.
        # P=1 zero-valid dummies keep a single traced code path.
        n_per = 1
        per_face = np.zeros((G, 1), dtype=np.int32)
        per_pos = np.zeros((G, 1), dtype=np.int32)
        per_src = np.zeros((G, 1), dtype=np.int32)
        per_cpl = np.zeros((G, 1, D, D))
        per_valid = np.zeros((G, 1))
        if self.has_periodic:
            rows = []
            for g in range(G):
                e_at = perm_safe[g]
                pv = pos_valid[g]
                ent = []
                for p in range(ne_pad):
                    if not pv[p]:
                        continue
                    e = e_at[p]
                    for f in range(nf):
                        if ops.periodic[e, f]:
                            ent.append(
                                (f, p, pos_of_elem[g, ops.neighbor[e, f]],
                                 ops.coupling[e, f])
                            )
                rows.append(ent)
            n_per = max(max(len(r) for r in rows), 1)
            per_face = np.zeros((G, n_per), dtype=np.int32)
            per_pos = np.zeros((G, n_per), dtype=np.int32)
            per_src = np.zeros((G, n_per), dtype=np.int32)
            per_cpl = np.zeros((G, n_per, D, D))
            per_valid = np.zeros((G, n_per))
            for g, ent in enumerate(rows):
                for i, (f, p, s, cpl) in enumerate(ent):
                    per_face[g, i] = f
                    per_pos[g, i] = p
                    per_src[g, i] = s
                    per_cpl[g, i] = cpl
                    per_valid[g, i] = 1.0

        # ---- lagged reflective BCs (legacy types 2/3): compact face lists --
        # Like the periodic tables above: per-iteration contributions built
        # from the PREVIOUS iterate and scattered into the hoisted rhs base.
        w_glob = quad.weights
        dif_t = None
        if self._dif_on:
            rows_d = np.argwhere(
                np.isin(ops.face_attr, diffuse_bcs)
                & (ops.neighbor < 0) & ops.face_valid
            )
            if len(rows_d) == 0:
                self._dif_on = False
            else:
                d_e, d_f = rows_d[:, 0], rows_d[:, 1]
                n_d = ops.normals[d_e, d_f]  # (P, dim)
                sdotn_g = np.einsum(
                    "gkd,pd->gkp", dirs_np[dirs_safe], n_d
                ) * dir_valid[..., None]  # (G, Km, P), padded slots zeroed
                cn = (
                    w_glob[:, None]
                    * np.maximum(-np.einsum("kd,pd->kp", dirs_np, n_d), 0.0)
                ).sum(axis=0)  # (P,) incoming-hemisphere weight
                areaF = ops.face_int[d_e, d_f].sum(axis=-1)  # |F| (P,)
                dif_t = dict(
                    elem=d_e,
                    pos=pos_of_elem[:, d_e].astype(np.int32),  # (G, P)
                    fint=ops.face_int[d_e, d_f],  # (P, D)
                    cin=np.minimum(sdotn_g, 0.0),  # (G, Km, P)
                    wplus=(
                        w_glob[dirs_safe][..., None] * dir_valid[..., None]
                        * np.maximum(sdotn_g, 0.0)
                    ),  # (G, Km, P)
                    norm=1.0 / np.maximum(cn * areaF, 1e-300),  # (P,)
                )
        spc_t = None
        if self._spc_on:
            from pbte.validation.oracle import mirror_direction_map

            rows_s = np.argwhere(
                np.isin(ops.face_attr, specular_bcs)
                & (ops.neighbor < 0) & ops.face_valid
            )
            if len(rows_s) == 0:
                self._spc_on = False
            else:
                s_e, s_f = rows_s[:, 0], rows_s[:, 1]
                n_s = ops.normals[s_e, s_f]  # (P, dim)
                if np.abs(np.abs(n_s).max(axis=-1) - 1.0).max() > 1e-9:
                    raise ValueError("specular faces must be axis-aligned")
                ax_p = np.argmax(np.abs(n_s), axis=-1)  # (P,)
                mirror = mirror_direction_map(
                    quad, self.dim, axes=set(int(a) for a in ax_p)
                )  # (dim, K) global-direction map
                # global direction -> (group, slot)
                g_of_dir, k_of_dir = planner.dir_slot_maps(dirs_pad)
                km_glob = mirror[ax_p[None, None, :], dirs_safe[..., None]]
                km_glob = np.where(
                    dir_valid[..., None], km_glob, 0
                )  # (G, Km, P)
                sdotn_g = np.einsum(
                    "gkd,pd->gkp", dirs_np[dirs_safe], n_s
                ) * dir_valid[..., None]
                spc_t = dict(
                    elem=s_e,
                    pos=pos_of_elem[:, s_e].astype(np.int32),  # (G, P)
                    fm=ops.face_mass[s_e, s_f],  # (P, D, D)
                    cin=np.minimum(sdotn_g, 0.0),  # (G, Km, P)
                    gk=(
                        g_of_dir[km_glob] * Km + k_of_dir[km_glob]
                    ).astype(np.int32),  # (G, Km, P) flat (g*, k*) index
                    src=pos_of_elem[
                        g_of_dir[km_glob], s_e[None, None, :]
                    ].astype(np.int32),  # (G, Km, P) source position in g*
                )

        # ---- ring-mode reflective tables ------------------------------------
        # The ring state is v = M^T u, so the closures read boundary values
        # through the element's M^-T: the diffuse flux vector folds to
        # fvec = fint @ M^-T and the specular face mass to fmv = fm @ M^-T.
        # Scatter positions are slab (level, slot) pairs per group, diffuse
        # rows first then specular (the gather/scatter column order).
        self._ring_refl_Pd = 0
        self._ring_refl = None
        if (self._dif_on or self._spc_on) and self.sweep_mode == "ring":
            rr = {}
            pls, pws = [], []
            if self._dif_on:
                im = self._ring_invMT_cls[
                    self._ring_cls[dif_t["elem"]]
                ]  # (P_d, D, D)
                rr["dif_fvec"] = np.einsum("pi,pij->pj", dif_t["fint"], im)
                pls.append(dif_t["pos"] // W)
                pws.append(dif_t["pos"] % W)
                self._ring_refl_Pd = dif_t["pos"].shape[1]
            if self._spc_on:
                im = self._ring_invMT_cls[self._ring_cls[spc_t["elem"]]]
                rr["spc_fmv"] = np.einsum("pil,plj->pij", spc_t["fm"], im)
                pls.append(spc_t["pos"] // W)
                pws.append(spc_t["pos"] % W)
            rr["pl"] = np.concatenate(pls, axis=1)  # (G, P_d + P_s)
            rr["pw"] = np.concatenate(pws, axis=1)
            self._ring_refl = rr

        # ---- ring-mode neighbor selection tables ---------------------------
        # Lattice meshes: NO tables at all — the upwind neighbor of slot w is
        # the previous level's slot w - shift (static per axis), so the scan
        # body reads it with a static pad+slice of the ring (zero selection
        # flops; the one-hot matmuls below cost (W*nf_act)/D ~ 7-21x the
        # useful coupling work).
        # General meshes: oh[g, l] maps the ring of the previous H solution
        # slabs to each face's upwind-neighbor values: (H*W, nf*W) per level,
        # consumed by one matmul per level (ring[KmBSD, HW] @ oh[HW, nfW])
        # — layout/semantics of ops.ring_plan.build_group_plan reused.
        ring_oh = None
        if self.sweep_mode == "ring" and self._ring_lattice:
            nf_act = self.dim
            act_f = self._lat_axis_faces  # (G, dim): slot j = axis j inflow
            act_valid = np.ones((G, nf_act), dtype=bool)
            self._ring_act_f = act_f
            self._ring_act_valid = act_valid
            self._ring_nf_act = nf_act
            # defense in depth: every valid interior upwind read must hit
            # the previous level's slab at exactly the static shift
            for g in range(G):
                for j, f in enumerate(act_f[g]):
                    psel = np.flatnonzero(
                        pos_valid[g] & (nbr_pos[g, f] >= 0)
                    )
                    if psel.size:
                        d = psel - nbr_pos[g, f, psel]
                        expect = W + self._ring_shift_vals[j]
                        assert np.all(d == expect), (
                            f"lattice shift mismatch g={g} axis={j}: "
                            f"offsets {np.unique(d)} != {expect}"
                        )
        elif self.sweep_mode == "ring":
            from pbte.ops import ring_plan as fs

            H_r = self._ring_H
            # ACTIVE faces per group: within one direction group only the
            # faces that can ever be inflow (cin < 0 for some valid slot)
            # contribute — on canonical-face hex octants that is exactly 3
            # of 6, halving the selection/coupling work and one-hot memory.
            cin_probe = np.einsum(
                "gefd,gkd->gkfe", ops.normals[perm_safe], dirs_np[dirs_safe]
            )
            cin_probe = np.minimum(cin_probe, 0.0) * dir_valid[:, :, None, None]
            active = [
                np.flatnonzero((cin_probe[g] < 0).any(axis=(0, 2)))
                for g in range(G)
            ]
            nf_act = max(max((len(a) for a in active), default=1), 1)
            # pad with a repeat of the first active face (its one-hot and
            # cin slots are zeroed for the padded entries)
            act_f = np.zeros((G, nf_act), dtype=np.int64)
            act_valid = np.zeros((G, nf_act), dtype=bool)
            for g, a in enumerate(active):
                a = a if len(a) else np.array([0])
                act_f[g, : len(a)] = a
                act_valid[g, : len(a)] = True
            self._ring_act_f = act_f
            self._ring_act_valid = act_valid
            self._ring_nf_act = nf_act
            oh = np.zeros((L, G, nf_act, H_r * W, W), dtype=np_dtype)
            for g in range(G):
                gp = fs.build_group_plan(nbr_pos[g], pos_valid[g], L, W, H_r)
                sel = gp.onehot[act_f[g]]  # (nf_act, HW, L, W)
                sel = sel * act_valid[g][:, None, None, None]
                oh[:, g] = sel.transpose(2, 0, 1, 3)  # (L, nf_act, HW, W)
            ring_oh = oh  # (L, G, nf_act, HW, W): L-MAJOR (see ring_cin)

        def gperm(a, extra_axes=None):
            """a (ne, ...) -> (G, ..., ne_pad) in group order, zero padded.
            Emits the solver dtype contiguously so device_put takes it
            without further astype/ascontiguousarray copies (those measured
            ~17s of the 1e5-element setup in f64)."""
            g = a[perm_safe].astype(np_dtype, copy=False)
            g = np.where(
                pos_valid.reshape(G, ne_pad, *([1] * (g.ndim - 2))),
                g,
                np.zeros((), dtype=np_dtype),
            )
            return np.ascontiguousarray(np.moveaxis(g, 1, -1))

        if self._scan_cls_ops:
            face_int_g = np.zeros((G, 1, 1, 1))  # rebuilt from cls_fint
            # Dirichlet ships the scalar g per face; the face integral is
            # rebuilt from the class cache inside the body
            dvec_g = gperm(dval, None) if self.has_dirichlet else None
        else:
            face_int_g = gperm(ops.face_int, None)  # (G, nf, D, ne_pad)
            dvec_g = gperm(dvec, None) if self.has_dirichlet else None
        bc_T_g = gperm(bc_T, None)  # (G, nf, ne_pad)
        basis_int_g = gperm(ops.basis_int, None)  # (G, D, ne_pad)
        # ring mode replaces the per-element mass/coupling streams with
        # class-compressed factors; ship 1-wide dummies to keep the consts
        # pytree uniform without the HBM (1.2GB coupling at hex-16^3)
        if self._scan_cls_ops:
            # class-compressed streams: the body rebuilds window operators
            # from (ncls, ...) caches; ship 1-wide dummies like ring mode
            mass_t_g = np.zeros((G, 1, 1, 1))
            coupling_g = np.zeros((G, 1, 1, 1, 1))
        elif self.sweep_mode == "ring":
            mass_t_g = np.zeros((G, 1, 1, 1))
            if self._ring_ccpl:
                coupling_g = np.zeros((G, 1, 1, 1, 1))
            else:
                # fold M_{neighbor}^-T into the per-element coupling (the
                # ring state is v = M^T u)
                nbr_c = self._ring_cls[np.clip(ops.neighbor, 0, None)]
                cpl_folded = np.einsum(
                    "efij,efjk->efik",
                    ops.coupling,
                    self._ring_invMT_cls[nbr_c],
                )
                coupling_g = gperm(cpl_folded, None)
        else:
            mass_t_g = gperm(np.swapaxes(ops.mass, -1, -2), None)  # (G,D,D,ne_pad)
            coupling_g = gperm(ops.coupling, None)  # (G, nf, D, D, ne_pad)

        fdot = np.einsum(
            "gefd,gkd->gkfe", ops.normals[perm_safe], dirs_np[dirs_safe]
        )  # (G, Km, nf, ne_pad)

        # ---- ring-mode slab constants --------------------------------------
        # Everything the ring scan consumes is pre-laid-out L-LEADING so each
        # scan step slices the xs arrays natively (no dynamic_slice, no
        # transposes): inflow coefficients (G, L, nf, Km, W) and the
        # u-independent boundary source (G, L, Km, D, W) — the latter is a
        # CONSTANT of the problem, so the whole bc einsum leaves the step.
        ring_cin = ring_bsrc0 = None
        if self.sweep_mode == "ring":
            cin_np = np.minimum(fdot, 0.0)  # (G, Km, nf, ne_pad)
            isb_np = nbr_pos < 0  # (G, nf, ne_pad)
            cin_bnd_np = np.where(isb_np[:, None], cin_np, 0.0)
            cin_int_np = np.where(isb_np[:, None], 0.0, cin_np)
            # active-face selection (see ring_oh build above)
            gi0 = np.arange(G)[:, None]
            cin_act = cin_int_np[gi0, :, self._ring_act_f]  # (G,nf_act,Km,E)
            ring_cin = np.ascontiguousarray(
                cin_act.reshape(G, self._ring_nf_act, Km, L, W)
                .transpose(3, 0, 1, 2, 4)
            )  # (L, G, nf_act, Km, W): L-MAJOR so the scan's per-level
            # slices hit contiguous memory (a G-major layout costs a full
            # relayout copy inside every step)
            bsrc0 = np.einsum(
                "gkfE,gfE,gfiE->gkiE", cin_bnd_np, bc_T_g, face_int_g,
                optimize=True,
            )
            if getattr(self, "_ring_wd", False):
                ring_bsrc0 = np.ascontiguousarray(
                    bsrc0.reshape(G, Km, D, L, W).transpose(3, 0, 1, 4, 2)
                )  # (L, G, Km, W, D) — WD layout (D minor)
            else:
                ring_bsrc0 = np.ascontiguousarray(
                    bsrc0.reshape(G, Km, D, L, W).transpose(3, 0, 1, 2, 4)
                )  # (L, G, Km, D, W)
            ring_dsrc0 = None
            if self.has_dirichlet:
                dsrc0 = np.einsum(
                    "gkfE,gfiE->gkiE", cin_bnd_np, dvec_g, optimize=True
                )
                ring_dsrc0 = np.ascontiguousarray(
                    dsrc0.reshape(G, Km, D, L, W).transpose(3, 0, 1, 2, 4)
                )  # (L, G, Km, D, W)
            # per-element coupling slab (multi-class meshes only; single-class
            # meshes use the (nf, D, D) class coupling in mats)
            ring_cpl = None
            if not self._ring_ccpl:
                cplg_act = coupling_g[gi0, self._ring_act_f]
                ring_cpl = np.ascontiguousarray(
                    cplg_act.reshape(G, self._ring_nf_act, D, D, L, W)
                    .transpose(4, 0, 1, 2, 3, 5)
                )  # (L, G, nf_act, D, D, W)
                if self._ring_lattice:
                    # the scan applies couplings to the UNSHIFTED ring and
                    # shifts the OUTPUT:  out[w] = C[w] @ ring[w - s]  ==
                    # shift_s( C'[v] @ ring[v] ) with C'[v] = C[v + s] —
                    # pre-shift the (receiver-slot) matrices here so the
                    # device never relayouts the slab-sized matmul operand
                    for fi, s in enumerate(self._ring_shift_vals):
                        if s:
                            ring_cpl[:, :, fi, :, :, :-s] = (
                                ring_cpl[:, :, fi, :, :, s:]
                            )
                            ring_cpl[:, :, fi, :, :, -s:] = 0.0
            # periodic slot tables in slab coordinates + static inflow coeffs
            # (ring state is v = M^T u: fold the source element's M^-T)
            if self.has_periodic:
                src_elem = perm_safe[np.arange(G)[:, None], per_src]
                per_cpl = np.einsum(
                    "gpij,gpjk->gpik",
                    per_cpl,
                    self._ring_invMT_cls[self._ring_cls[src_elem]],
                )
            gi2 = np.arange(G)[:, None]
            per_cin = (
                np.minimum(fdot[gi2, :, per_face, per_pos], 0.0)
                * per_valid[:, :, None]
            ).transpose(0, 2, 1)  # (G, Km, P)
            per_pl, per_pw = per_pos // W, per_pos % W
            per_sl, per_sw = per_src // W, per_src % W

        self._dir_sharding = dir_sharding
        put = lambda a: jax.device_put(np.ascontiguousarray(a, dtype=np_dtype))
        iput = lambda a: jax.device_put(np.ascontiguousarray(a, dtype=np.int32))

        def sput(a, dt=np_dtype, band_axis=None):
            a = np.ascontiguousarray(a, dtype=dt)
            if dir_sharding is None:
                return jax.device_put(a)
            return jax.device_put(
                a, self._slot_sharding(a, band_axis=band_axis)
            )

        # ---- transport operator (host, float64, chunked batched inverse) ---
        vg_s = vg / self.dt_inv  # non-dimensionalized group velocity
        if self.sweep_mode == "ring" or self._scan_cls_ops:
            mass_g = np.zeros((G, 1, 1, 1))  # class factors replace these
        else:
            stiff_g = ops.stiff[perm_safe]  # (G, ne_pad, dim, D, D)
            fmass_g = ops.face_mass[perm_safe]  # (G, ne_pad, nf, D, D)
            mass_g = ops.mass[perm_safe]  # (G, ne_pad, D, D)
            if self.padded:
                # inert padding: identity mass, zero transport
                stiff_g = np.where(
                    pos_valid[..., None, None, None], stiff_g, 0.0
                )
                fmass_g = np.where(
                    pos_valid[..., None, None, None], fmass_g, 0.0
                )
                mass_g = np.where(
                    pos_valid[..., None, None], mass_g, np.eye(D)
                )

        def _class_full_mats():
            # Class-batched FULL factors for the SCAN path: A^-1 stored per
            # geometry class — (G, Km, BS, D, D, ncls) plus a (G, ncls,
            # ne_pad) one-hot — the exact-inverse analog of the eigen class
            # mode below. Two hazards it avoids: (a) the eigen factor pair's
            # cond(V) error amplification (p=3 tet operators measured up to
            # ~1e11), (b) the scan-mode on-the-fly policy's in-body batched
            # jnp.linalg.inv at the legacy 16x24-angle tet shape. Memory is
            # ne_pad/ncls below the per-element full cache (legacy tet 5^3:
            # 13.8 GB -> 110 MB).
            ncls = self.ncls
            reps = self._cls_reps
            cls_pos = np.where(pos_valid, self._cls[perm_safe], 0)
            onehot = np.zeros((G, ncls, ne_pad), dtype=np_dtype)
            for g in range(G):
                onehot[g, cls_pos[g], np.arange(ne_pad)] = 1.0
            stiff_r = ops.stiff[reps]  # (ncls, dim, D, D)
            fmass_r = ops.face_mass[reps]  # (ncls, nf, D, D)
            mass_r = ops.mass[reps]  # (ncls, D, D)
            norm_r = ops.normals[reps]  # (ncls, nf, dim)
            a_cls = np.empty((G, Km, BS, D, D, ncls), dtype=np_dtype)
            for g in range(G):
                dk = dirs_np[dirs_safe[g]]  # (Km, dim)
                fd = np.einsum("cfd,kd->kcf", norm_r, dk)
                G_k = -np.einsum("kd,cdij->kcij", dk, stiff_r) + np.einsum(
                    "kcf,cfij->kcij", np.maximum(fd, 0.0), fmass_r
                )  # (Km, ncls, D, D)
                A_g = (
                    mass_r[None, None]
                    + vg_s[None, :, None, None, None] * G_k[:, None]
                )  # (Km, BS, ncls, D, D)
                a_cls[g] = np.moveaxis(
                    np.linalg.inv(A_g), 2, -1
                ).astype(np_dtype)
            return (jax.device_put(a_cls), jax.device_put(onehot))

        if self.sweep_mode == "ring":
            # Class-batched FULL factors: A^-1 per (group, class, slot, band),
            # (G, ncls, Km, BS, D, D) — a few dense 27x27 inverses instead of
            # ne_pad of them. Default apply precision is fine here: unlike
            # the eigen factor pair, A^-1 applies carry no cond(V)
            # amplification.
            ncls = self.ncls_ring
            reps = np.array(
                [int(np.flatnonzero(self._ring_cls == c)[0])
                 for c in range(ncls)]
            )
            stiff_r = ops.stiff[reps]  # (ncls, dim, D, D)
            fmass_r = ops.face_mass[reps]
            mass_r = ops.mass[reps]
            norm_r = ops.normals[reps]  # (ncls, nf, dim)
            # MASS-TRANSFORMED state: the ring carries v = M^T u, so the
            # pseudo-time term is relax*v (no per-step mass matmul and its
            # state-sized stream), the apply factor is
            # B = M^T A^-1, and M^-T folds into the neighbor couplings.
            from pbte.fem import supercell as _supercell_mod

            massT_r = np.swapaxes(mass_r, -1, -2)
            invMT_r = self._ring_invMT_cls  # (ncls, D, D)
            a_cls = np.empty((G, ncls, Km, BS, D, D), dtype=np_dtype)

            def _factor_group(g):
                dk = dirs_np[dirs_safe[g]]  # (Km, dim)
                fd = np.einsum("cfd,kd->ckf", norm_r, dk)
                G_k = -np.einsum("kd,cdij->ckij", dk, stiff_r) + np.einsum(
                    "ckf,cfij->ckij", np.maximum(fd, 0.0), fmass_r
                )
                if self._super is not None:
                    # intra-cell outflow/inflow of the block super element
                    # (the inflow coupling moves INTO the block-triangular
                    # A — the exactness of the supercell merge)
                    G_k = G_k + self._super.gmat_internal(dk)[None]
                A = (
                    mass_r[:, None, None]
                    + vg_s[None, None, :, None, None] * G_k[:, :, None]
                )  # (ncls, Km, BS, D, D)
                if self._super is not None:
                    # block forward substitution on the block-triangular
                    # super operator: gsz DxD inverses + a few DxD matmuls
                    # per (k, b) instead of a dense (gsz*D)^3 inverse —
                    # the dominant setup cost at the legacy full-K shape
                    # (minutes of dense 120x120 np.linalg.inv on the host)
                    sc_ = self._super
                    massT_blk = np.swapaxes(
                        ops.mass[reps][0], -1, -2
                    ).reshape(sc_.gsz, sc_.D, sc_.gsz, sc_.D)
                    massT_blocks = np.stack(
                        [massT_blk[c, :, c, :] for c in range(sc_.gsz)]
                    )
                    a_cls[g] = _supercell_mod.block_triangular_factor(
                        sc_, A[0], dk, massT_blocks
                    )[None].astype(np_dtype)
                else:
                    # batched BLAS matmul: the einsum form ran single-
                    # thread without BLAS (~44 s of the legacy-tet setup)
                    a_cls[g] = np.matmul(
                        massT_r[:, None, None], np.linalg.inv(A)
                    ).astype(np_dtype)

            # LAPACK releases the GIL: thread the per-group f64 inverse
            # batches (the dominant setup cost at the legacy full-K tet
            # shape — 20k dense 120x120 inverses)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(G, 8)) as tp:
                list(tp.map(_factor_group, range(G)))
            # per-element M^-T (by class) for output-time v -> u conversion
            # and the macroscopic closure
            self._ring_invMT = invMT_r[self._ring_cls]  # (ne, D, D)
            # class id per padded slot -> one-hot slabs (G, L, ncls, W)
            cls_pos = np.where(pos_valid, self._ring_cls[perm_safe], -1)
            cls_oh = np.zeros((L, G, ncls, W), dtype=np_dtype)
            gi, pi = np.nonzero(cls_pos >= 0)
            cls_oh[pi // W, gi, cls_pos[gi, pi], pi % W] = 1.0
            # class mass transposes for the rhs base: the per-element
            # "ijE,kbjE->kbiE" batched dot is a tiny-batched contraction with
            # a large temporary; class-dense (D,D)@(D, Km*BS*ne) matmuls are
            # plain large GEMMs
            massT_cls = np.ascontiguousarray(
                np.swapaxes(ops.mass[reps], -1, -2), dtype=np_dtype
            )  # (ncls, D, D)
            # class-compressed neighbor coupling (single-class meshes): the
            # per-element coupling stream is 1.2GB at hex-16^3 and identical
            # across elements after face canonicalization; boundary faces are
            # masked by cin so their zeroed entries are never read
            ccpl = self._ring_ccpl_arr
            massT_G = np.broadcast_to(
                massT_cls, (G,) + massT_cls.shape
            ).copy()  # (G, ncls, D, D)
            ccpl_G = None
            bcv_G = None
            if self._ring_ccpl:
                ccpl_G = np.einsum(
                    "fij,jk->fik", ccpl[0], invMT_r[0]
                ).astype(np_dtype)[self._ring_act_f]  # (G, nf_act, D, D)
                # Supercell problems skip the folded factor: at D' = gsz*D
                # the concatenated bcat is (1+dim)*gsz times B (14 GB at the
                # legacy full-K tet shape) while the coupling C is GEOMETRY-
                # ONLY (shared over k, b) — the body then applies C as its
                # own (D', nf*D') GEMM with (Km*BS*W)-wide free dims and B
                # as the per-(k,b) factor. PBTE_SUPER_FOLD=1 forces the
                # folded form for A/B at subset shapes.
                fold_ok = (
                    self._super is None
                    or os.environ.get("PBTE_SUPER_FOLD", "") == "1"
                )
                # PBTE_RING_FOLD=0 forces the two-matmul body on ANY
                # lattice (geometry-shared C as one big GEMM + per-(k,b) B;
                # the supercell default, whose folded bcat would be
                # (1+dim)*gsz times B)
                if os.environ.get("PBTE_RING_FOLD", "") == "0":
                    fold_ok = False
                if self._ring_lattice and fold_ok:
                    # FOLDED + CONCATENATED neighbor factors for the
                    # lattice ring:
                    #   sol = B @ rhs,  rhs = base - sum_f vg C_f @ un_f
                    #   ==>  sol = [B | -vg B C_0 | ... ] @ [base; un_0; ...]
                    # ONE per-level matmul with contraction (1+nf_act)*D =
                    # 108 instead of four small 27-contractions, which
                    # lower to poorly shaped batched matmuls. Factors folded
                    # in f64 at setup.
                    bcv_G = np.einsum(
                        "gkbij,gfjl,b->gfkbil",
                        a_cls[:, 0].astype(np.float64),
                        ccpl_G.astype(np.float64),
                        vg_s,
                    )  # (G, nf_act, Km, BS, D, D)
                    bcat_G = np.concatenate(
                        [a_cls[:, 0].astype(np.float64)[:, None], -bcv_G],
                        axis=1,
                    )  # (G, 1+nf_act, Km, BS, D, D)
                    bcat_G = np.ascontiguousarray(
                        np.moveaxis(bcat_G, 1, -2)
                    ).reshape(
                        G, Km, BS, D, -1
                    ).astype(np_dtype)  # (G, Km, BS, D, (1+nf_act)*D)
                    bcv_G = bcat_G
                self._ring_fold = bcv_G is not None
            # per-BUCKET factor tuples (groups sliced, Km trimmed)
            mats = tuple(
                (
                    jax.device_put(
                        np.ascontiguousarray(a_cls[gs][:, :, :km_b])
                    ),
                    jax.device_put(np.ascontiguousarray(cls_oh[:, gs])),
                    jax.device_put(np.ascontiguousarray(massT_G[gs])),
                )
                + (
                    (jax.device_put(np.ascontiguousarray(ccpl_G[gs])),)
                    if self._ring_ccpl
                    else ()
                )
                + (
                    # bf16 staging stores the folded factor stationary in
                    # bf16 too (pure-bf16 dot with f32 accumulation)
                    (jax.device_put(jnp.asarray(
                        np.ascontiguousarray(bcv_G[gs][:, :km_b]),
                        dtype=jnp.bfloat16 if self._ring_stage_bf16
                        else np_dtype,
                    )),)
                    if bcv_G is not None
                    else ()
                )
                for gs, km_b in self._ring_buckets
            )
        elif cache_policy == "full" and self._cls is not None:
            mats = _class_full_mats()
        elif cache_policy == "full":
            a_inv = np.empty((G, Km, BS, D, D, ne_pad), dtype=np_dtype)
            for g in range(G):
                G_g = -np.einsum(
                    "kd,edij->keij", dirs_np[dirs_safe[g]], stiff_g[g]
                ) + np.einsum(
                    "kfe,efij->keij", np.maximum(fdot[g], 0.0), fmass_g[g]
                )
                A_g = (
                    mass_g[g][None, None]
                    + vg_s[None, :, None, None, None] * G_g[:, None]
                )  # (Km, BS, ne, D, D)
                a_inv[g] = np.moveaxis(np.linalg.inv(A_g), 2, -1).astype(np_dtype)
            mats = sput(a_inv, band_axis=2)
            del a_inv
        elif cache_policy == "eigen":
            # Eigendecomposition compression: A(vg) = M (I + vg C) with
            # C = M^-1 G = V diag(lam) V^-1, so
            #   A^-1(vg) = V diag(1/(1 + vg lam)) (V^-1 M^-1)
            # The factors are BAND-INDEPENDENT: storage/transfer shrink ~10x
            # (2 complex D x D per (dir, elem) instead of BS real ones) and
            # the decomposition count shrinks BS-fold. Eigenvector
            # conditioning is benign on hex/quad operators (cond(V) ~ 1e2,
            # f64 reconstruction error ~1e-14) but NOT universally: p=3 tet
            # operators measured cond(V) up to 7e8, which destroys the
            # factor pair in f32 (divergence -> NaN around iteration 10).
            # A conditioning guard below falls back to the on-the-fly
            # policy when the estimate exceeds the dtype's safe bound.
            # The complex pair structure costs 4x flops on the apply,
            # amortized by the ~10x fewer factor bytes.
            # complex arithmetic is split into real/imaginary parts, so
            # every contraction is a real matmul
            #
            # CLASS MODE: on translation-invariant meshes elements fall into
            # a handful of geometry classes (fem.assembly.element_classes);
            # factors are then stored per CLASS — (G, Km, 2, D, D, ncls)
            # instead of (..., ne) — and the level body rebuilds the window
            # factors with a tiny one-hot matmul. This cuts the factor cache
            # by ne/ncls (hex 16^3: ~680x), removes the per-level HBM factor
            # stream, and collapses setup from O(ne) to O(ncls)
            # eigendecompositions per direction.
            if self._cls is not None and not self.padded:
                ncls = self.ncls
                reps = self._cls_reps  # (ncls,) representative elements
                # class id at each group-ordered position (padding -> class 0,
                # harmless: padded slots are never read)
                cls_pos = np.where(pos_valid, self._cls[perm_safe], 0)
                onehot = np.zeros((G, ncls, ne_pad), dtype=np_dtype)
                for g in range(G):
                    onehot[g, cls_pos[g], np.arange(ne_pad)] = 1.0
                P = np.empty((G, Km, 2, D, D, ncls), dtype=np_dtype)
                Qm = np.empty((G, Km, 2, D, D, ncls), dtype=np_dtype)
                lam = np.empty((G, Km, 2, D, ncls), dtype=np_dtype)
                stiff_r = ops.stiff[reps]  # (ncls, dim, D, D)
                fmass_r = ops.face_mass[reps]
                Minv_r = np.linalg.inv(ops.mass[reps])
                norm_r = ops.normals[reps]  # (ncls, nf, dim)
                cond_max = 0.0
                for g in range(G):
                    for k in range(Km):
                        dk = dirs_np[dirs_safe[g, k]]
                        fd = np.einsum("cfd,d->cf", norm_r, dk)
                        G_k = -np.einsum("d,cdij->cij", dk, stiff_r) + np.einsum(
                            "cf,cfij->cij", np.maximum(fd, 0.0), fmass_r
                        )
                        C = Minv_r @ G_k  # (ncls, D, D)
                        w, V = np.linalg.eig(C)
                        Vinv = np.linalg.inv(V)
                        # Frobenius cond estimate (upper-bound flavor)
                        cond_max = max(cond_max, float((
                            np.linalg.norm(V, axis=(1, 2))
                            * np.linalg.norm(Vinv, axis=(1, 2))
                        ).max()))
                        Q_c = Vinv @ Minv_r
                        P[g, k, 0] = V.real.transpose(1, 2, 0)
                        P[g, k, 1] = V.imag.transpose(1, 2, 0)
                        Qm[g, k, 0] = Q_c.real.transpose(1, 2, 0)
                        Qm[g, k, 1] = Q_c.imag.transpose(1, 2, 0)
                        lam[g, k, 0] = w.real.T
                        lam[g, k, 1] = w.imag.T
                mats = (
                    jax.device_put(P),
                    jax.device_put(Qm),
                    jax.device_put(lam),
                    jax.device_put(onehot),
                )
            else:
                P = np.empty((G, Km, 2, D, D, ne_pad), dtype=np_dtype)
                Qm = np.empty((G, Km, 2, D, D, ne_pad), dtype=np_dtype)
                lam = np.empty((G, Km, 2, D, ne_pad), dtype=np_dtype)
                cond_max = 0.0
                for g in range(G):
                    Minv_g = np.linalg.inv(mass_g[g])  # (ne, D, D)
                    for k in range(Km):
                        G_k = -np.einsum(
                            "d,edij->eij", dirs_np[dirs_safe[g, k]], stiff_g[g]
                        ) + np.einsum(
                            "fe,efij->eij", np.maximum(fdot[g, k], 0.0), fmass_g[g]
                        )
                        C = Minv_g @ G_k  # (ne, D, D)
                        w, V = np.linalg.eig(C)  # batched complex
                        Vinv = np.linalg.inv(V)
                        cond_max = max(cond_max, float((
                            np.linalg.norm(V, axis=(1, 2))
                            * np.linalg.norm(Vinv, axis=(1, 2))
                        ).max()))
                        Q_c = Vinv @ Minv_g
                        P[g, k, 0] = V.real.transpose(1, 2, 0)
                        P[g, k, 1] = V.imag.transpose(1, 2, 0)
                        Qm[g, k, 0] = Q_c.real.transpose(1, 2, 0)
                        Qm[g, k, 1] = Q_c.imag.transpose(1, 2, 0)
                        lam[g, k, 0] = w.real.T
                        lam[g, k, 1] = w.imag.T
                mats = (jax.device_put(P), jax.device_put(Qm), jax.device_put(lam))
            # conditioning guard: ill-conditioned eigenvectors destroy the
            # V / V^-1 factor pair — per-apply error ~ cond(V) * eps, which
            # the source iteration amplifies into divergence (p=3 tet
            # operators measured cond up to 7e8: f32 NaN'd by iteration 10).
            cond_bound = 1e5 if np_dtype == np.float32 else 1e11
            if cond_max > cond_bound:
                import warnings

                fb = "class-batched full" if self._cls is not None \
                    else "on-the-fly"
                warnings.warn(
                    f"cache_policy='eigen': eigenvector condition estimate "
                    f"{cond_max:.1e} exceeds the safe bound {cond_bound:.0e} "
                    f"for {np_dtype}; falling back to {fb} factors"
                )
                if self._cls is not None:
                    cache_policy = self.cache_policy = "full"
                    mats = _class_full_mats()
                else:
                    cache_policy = self.cache_policy = "on-the-fly"
                    self.ncls = 0
        if self.sweep_mode != "ring" and cache_policy == "on-the-fly":
            G_mat = np.empty((G, Km, D, D, ne_pad))
            for g in range(G):
                G_g = -np.einsum(
                    "kd,edij->keij", dirs_np[dirs_safe[g]], stiff_g[g]
                ) + np.einsum(
                    "kfe,efij->keij", np.maximum(fdot[g], 0.0), fmass_g[g]
                )
                G_mat[g] = G_g.transpose(0, 2, 3, 1)
            mats = sput(G_mat)

        # ---- device constants ------------------------------------------------
        # slot-shaped macroscopic weights; padded slots/bands weigh zero
        mw = macroscopic.macro_weights(quad, tables)  # (K, BS_orig)
        fw = macroscopic.flux_weights(quad, tables, self.dim)
        if BS != self.BS_orig:
            bpad = BS - self.BS_orig
            mw = np.pad(mw, ((0, 0), (0, bpad)))
            fw = np.pad(fw, ((0, 0), (0, 0), (0, bpad)))
        mw_slots = np.where(dir_valid[..., None], mw[dirs_safe], 0.0)
        fw_slots = np.where(
            dir_valid[None, ..., None],
            fw[:, dirs_safe.reshape(-1)].reshape(self.dim, G, Km, BS),
            0.0,
        )

        # on-the-fly factorization working set: the batched (..., D, D)
        # inverses of all G groups under one vmap. Above its share of device
        # memory, groups run sequentially. PBTE_SEQ_GROUPS=1 forces
        # sequential groups for ANY scan policy: per-group window buffers
        # (neighbor gathers, einsum temporaries) scale with the vmapped
        # group count (the full 16x24-angle legacy tet shape has G*Km = 1128
        # slots) — lax.map trades that peak for one extra level of
        # sequencing (directions inside a group stay batched).
        inv_ws = (
            3 * G * Km * BS * self.W * D * D * np.dtype(np_dtype).itemsize
        )
        self._seq_groups = self.sweep_mode != "ring" and (
            (cache_policy == "on-the-fly" and inv_ws > lim["seq_groups"])
            or os.environ.get("PBTE_SEQ_GROUPS", "") == "1"
        )

        def _win_slices(a, l_axis=0):
            """(L, ..., W) numpy -> tuple over ring segments of contiguous
            (L_s, ..., Ws) hull windows (see self._ring_segs)."""
            out = []
            for (l0, l1, o0, dlt, Ws) in self._ring_segs:
                rows = [
                    a[l][..., o0 + dlt * (l - l0): o0 + dlt * (l - l0) + Ws]
                    for l in range(l0, l1)
                ]
                out.append(np.ascontiguousarray(np.stack(rows)))
            return tuple(out)

        ring_pos_win = None
        if self._ring_windowed:
            # per-segment seg-local flat position of each element (or -1):
            # slot l*W + w  ->  (l - l0) * Ws + (w - off_l)
            lvl_of = pos_of_elem // self.W  # (G, ne)
            w_of = pos_of_elem % self.W
            ring_pos_win = []
            covered = np.zeros_like(pos_of_elem, dtype=bool)
            for (l0, l1, o0, dlt, Ws) in self._ring_segs:
                inseg = (lvl_of >= l0) & (lvl_of < l1)
                off_l = o0 + dlt * (lvl_of - l0)
                wrel = w_of - off_l
                ok = inseg & (wrel >= 0) & (wrel < Ws)
                assert bool((ok == inseg).all()), (
                    "ring window does not cover a valid slot"
                )
                ring_pos_win.append(
                    np.where(ok, (lvl_of - l0) * Ws + wrel, -1).astype(
                        np.int32
                    )
                )
                covered |= ok
            assert bool(covered.all()), "element missing from all windows"

        self.consts = dict(
            # lagged reflective BC tables (legacy types 2/3), empty unless on;
            # the scan path scatters at element positions, the ring path at
            # slab (level, slot) pairs through M^-T-folded vectors
            **(
                {
                    "dif_fint": put(dif_t["fint"]),
                    "dif_cin": put(dif_t["cin"]),
                    "dif_wplus": put(dif_t["wplus"]),
                    "dif_norm": put(dif_t["norm"]),
                    **(
                        {"dif_fvec": put(self._ring_refl["dif_fvec"])}
                        if self.sweep_mode == "ring"
                        else {"dif_pos": iput(dif_t["pos"])}
                    ),
                }
                if self._dif_on else {}
            ),
            **(
                {
                    "spc_cin": put(spc_t["cin"]),
                    "spc_gk": iput(spc_t["gk"]),
                    **(
                        {"spc_fmv": put(self._ring_refl["spc_fmv"])}
                        if self.sweep_mode == "ring"
                        else {
                            "spc_pos": iput(spc_t["pos"]),
                            "spc_fm": put(spc_t["fm"]),
                            "spc_src": iput(spc_t["src"]),
                        }
                    ),
                }
                if self._spc_on else {}
            ),
            **(
                {
                    "cls_massT": put(self._cls_massT),  # (ncls, D, D)
                    "cls_cpl": put(self._cls_cpl),  # (ncls, nf, D, D)
                    "cls_fint": put(self._cls_fint),  # (ncls, nf, D)
                }
                if self._scan_cls_ops else {}
            ),
            mass_t=put(mass_t_g),  # (G, D, D, ne_pad): Mt[g,i,j,p]=mass[e_p,j,i]
            mass=put(np.moveaxis(mass_g, 1, -1)),  # (G, D, D, ne_pad)
            basis_int=put(basis_int_g),  # (G, D, ne_pad)
            basis_int_glob=put(ops.basis_int),  # (ne, D) global layout
            **(
                {
                    # fine-element basis integrals + block->fine scatter
                    # for the per-element Tv reduction
                    "super_basis": put(self._super.basis_int_cells),
                    "super_scat": iput(self._super.scatter_fine()),
                }
                if self._super is not None
                else {}
            ),
            face_int=put(face_int_g),  # (G, nf, D, ne_pad)
            coupling=put(coupling_g),  # (G, nf, D, D, ne_pad)
            nbr_pos=iput(nbr_pos),  # (G, nf, ne_pad), -1 bdry/pad
            bc_T=put(bc_T_g),  # (G, nf, ne_pad)
            pos_of_elem=iput(pos_of_elem),  # (G, ne)
            perm=iput(perm_safe),  # (G, ne_pad): global elem at position (safe)
            offsets=iput(offsets),  # (G, L) level start positions
            counts=iput(counts),  # (G, L) level widths
            vg=put(vg_s),
            src_w=put(inv_kn * heat_cap / (self.omega * self.dt_inv)),
            relax_w=put(1.0 - inv_kn / self.dt_inv),
            bc_w=put(heat_cap / self.omega),
            macro_w=sput(mw_slots, band_axis=2),  # (G, Km, BS)
            flux_w=sput(np.moveaxis(fw_slots, 0, -1), band_axis=2),  # (G, Km, BS, dim)
            fdot=sput(fdot),  # (G, Km, nf, ne_pad)
            mats=mats,
            per_face=iput(per_face),  # (G, P) periodic slot tables
            per_pos=iput(per_pos),
            per_src=iput(per_src),
            per_cpl=put(per_cpl),  # (G, P, D, D)
            per_valid=put(per_valid),  # (G, P) 1.0 real / 0.0 padding
            **(
                {
                    "ring_invMT": put(self._ring_invMT),  # (ne, D, D)
                    # per-BUCKET slab constants (groups sliced, Km trimmed):
                    # see self._ring_buckets
                    "ring_b": tuple(
                        {
                            **(
                                {"oh": put(ring_oh[:, gs])}
                                if ring_oh is not None
                                else {}
                            ),
                            **(
                                {
                                    # hull-windowed per-segment consts; the
                                    # full-W slabs are not shipped at all
                                    "segs": tuple(
                                        {
                                            "cin": put(cw),
                                            "bsrc0": put(bw),
                                            "pwin": iput(pw),
                                            "vwin": put(vw),
                                            **(
                                                {"dsrc0": put(dw)}
                                                if dw is not None
                                                else {}
                                            ),
                                        }
                                        for cw, bw, pw, vw, dw in zip(
                                            _win_slices(
                                                ring_cin[:, gs][
                                                    :, :, :, :km_b]
                                            ),
                                            _win_slices(
                                                ring_bsrc0[:, gs, :km_b]
                                            ),
                                            _win_slices(
                                                np.moveaxis(
                                                    perm_safe.reshape(
                                                        G, L, self.W
                                                    )[gs], 0, 1
                                                ).astype(np.int32)
                                            ),
                                            _win_slices(
                                                np.moveaxis(
                                                    pos_valid.reshape(
                                                        G, L, self.W
                                                    )[gs], 0, 1
                                                ).astype(np_dtype)
                                            ),
                                            _win_slices(
                                                ring_dsrc0[:, gs, :km_b]
                                            )
                                            if ring_dsrc0 is not None
                                            else (None,)
                                            * len(self._ring_segs),
                                        )
                                    )
                                }
                                if self._ring_windowed
                                else {
                                    "cin": put(
                                        ring_cin[:, gs][:, :, :, :km_b]
                                    ),
                                    "bsrc0": put(ring_bsrc0[:, gs, :km_b]),
                                }
                            ),
                            "macro_w": put(mw_slots[gs, :km_b]),
                            "per_cpl": put(per_cpl[gs]),
                            "per_cin": put(per_cin[gs][:, :km_b]),
                            "per_pl": iput(per_pl[gs]),
                            "per_pw": iput(per_pw[gs]),
                            "per_sl": iput(per_sl[gs]),
                            "per_sw": iput(per_sw[gs]),
                            **(
                                {
                                    "refl_pl": iput(
                                        self._ring_refl["pl"][gs]
                                    ),
                                    "refl_pw": iput(
                                        self._ring_refl["pw"][gs]
                                    ),
                                }
                                if self._ring_refl is not None
                                else {}
                            ),
                            **(
                                {"cpl": put(ring_cpl[:, gs])}
                                if ring_cpl is not None
                                else {}
                            ),
                            **(
                                {"dsrc0": put(ring_dsrc0[:, gs, :km_b])}
                                if ring_dsrc0 is not None
                                and not self._ring_windowed
                                else {}
                            ),
                        }
                        for gs, km_b in self._ring_buckets
                    ),
                    **(
                        {
                            # seg-local flat position of each element for
                            # the windowed macroscopic closure
                            "ring_pos_win": tuple(
                                iput(pw) for pw in ring_pos_win
                            )
                        }
                        if self._ring_windowed
                        else {}
                    ),
                    # inert padding: zero the lagged-temperature source on
                    # padded slots so they stay EXACTLY zero through every
                    # iteration (they start zero, bc_T/bsrc0 are zeroed by
                    # gperm, and relax*0 = 0) — no garbage can grow into
                    # inf/nan over long convergence runs
                    "valid_slab": put(
                        pos_valid.reshape(G, L, W)
                        .transpose(1, 0, 2)
                        .astype(np_dtype)
                    ),  # (L, G, W)
                }
                if self.sweep_mode == "ring"
                else {}
            ),
            **(
                {"dvec": put(dvec_g)}
                if self.has_dirichlet and self.sweep_mode != "ring"
                else {}
            ),
        )

        def _jit(fn, donate=()):
            if self.matmul_precision is None:
                return jax.jit(fn, donate_argnums=donate)
            prec = self.matmul_precision

            def wrapped(*args):
                with jax.default_matmul_precision(prec):
                    return fn(*args)

            return jax.jit(wrapped, donate_argnums=donate)

        # ring mode: donating the state u lets XLA alias the large state
        # buffers, but XLA then COPIES the scan's ys into the donated buffer
        # every step. Default: no donation while one state buffer is within
        # its share of device memory; donate above that (the memory-bound
        # regime where the copy is the price of fitting at all).
        # PBTE_RING_DONATE=1 / PBTE_RING_NO_DONATE=1 override.
        if os.environ.get("PBTE_RING_NO_DONATE", "") == "1":
            donate_ring = False
        elif os.environ.get("PBTE_RING_DONATE", "") == "1":
            donate_ring = True
        else:
            slot_tot = (
                sum((l1 - l0) * Ws for l0, l1, _, _, Ws in self._ring_segs)
                if self._ring_windowed
                else L * self.W
            )
            st_isize = 2 if self._ring_state_bf16 else np.dtype(
                np_dtype).itemsize
            state_b = (
                sum(sizes) + G
            ) * BS * D * slot_tot * st_isize
            donate_ring = state_b > lim["donate"]
        self._donate_ring = self.sweep_mode == "ring" and donate_ring
        self._step = _jit(
            self._step_impl,
            donate=(1,) if self.sweep_mode == "ring" and donate_ring
            else (),
        )
        # accelerated solve re-reads x after computing F(x), so it needs a
        # non-donating step; alias the main jit when donation is off anyway
        # (no second compile)
        self._step_plain = (
            self._step
            if not (self.sweep_mode == "ring" and donate_ring)
            else _jit(self._step_impl)
        )

    def _slot_sharding(self, a, km_axis=1, band_axis=None):
        """NamedSharding for a slot-major array: shard the Km axis, plus the
        spectral-band axis when the dir_sharding spec names one."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        dspec = list(getattr(self._dir_sharding, "spec", ["dir"]))
        spec = [None] * a.ndim
        spec[km_axis] = dspec[0] if dspec else None
        if band_axis is not None and len(dspec) > 1 and dspec[1] is not None:
            spec[band_axis] = dspec[1]
        while spec and spec[-1] is None:  # the spec XLA gives the outputs
            spec.pop()
        return NamedSharding(self._dir_sharding.mesh, P(*spec))

    # -- state -------------------------------------------------------------

    def initial_state(self):
        """Zero coefficients/Tc/Tv (ref: PBTESolver::CreateInitialCoefficients)."""
        import jax
        import jax.numpy as jnp

        if self.sweep_mode == "ring":
            # tuple of per-BUCKET L-MAJOR slabs, (Km_b, D, BS, W) trailing
            sdt = (
                jnp.bfloat16 if self._ring_state_bf16 else self.dtype
            )

            def _zeros(shape):
                z = jnp.zeros(shape, dtype=sdt)
                if self._dir_sharding is not None:
                    z = jax.device_put(
                        z,
                        self._slot_sharding(
                            np.empty(shape), km_axis=2, band_axis=4
                        ),
                    )
                return z

            if self._ring_wd:
                # WD layout: D' minor
                def _zeros_wd(shape):
                    z = jnp.zeros(shape, dtype=sdt)
                    if self._dir_sharding is not None:
                        z = jax.device_put(
                            z,
                            self._slot_sharding(
                                np.empty(shape), km_axis=2, band_axis=3
                            ),
                        )
                    return z

                u = tuple(
                    _zeros_wd(
                        (self.L, len(gs), km_b, self.BS, self.W, self.D)
                    )
                    for gs, km_b in self._ring_buckets
                )
            elif self._ring_windowed:
                # per-bucket TUPLE over hull-window segments
                u = tuple(
                    tuple(
                        _zeros(
                            (l1 - l0, len(gs), km_b, self.D, self.BS, Ws)
                        )
                        for (l0, l1, _, _, Ws) in self._ring_segs
                    )
                    for gs, km_b in self._ring_buckets
                )
            else:
                u = tuple(
                    _zeros((self.L, len(gs), km_b, self.D, self.BS, self.W))
                    for gs, km_b in self._ring_buckets
                )
            return (u,) + self._initial_macro()
        else:
            shape = (self.G, self.Km, self.BS, self.D, self.ne_pad)
        if self._dir_sharding is not None:
            km_ax = 2 if self.sweep_mode == "ring" else 1
            # ring layout is (L, G, Km, D, BS, W): the band axis sits at 4
            band_ax = 4 if self.sweep_mode == "ring" else km_ax + 1
            u = jax.device_put(
                jnp.zeros(shape, dtype=self.dtype),
                self._slot_sharding(
                    np.empty(shape), km_axis=km_ax, band_axis=band_ax
                ),
            )
        else:
            u = jnp.zeros(shape, dtype=self.dtype)
        return (u,) + self._initial_macro()

    def _initial_macro(self):
        """Zero Tc and Tv. Under dir_sharding they are replicated over the
        mesh, the sharding the step gives its outputs, so the second step
        reuses the first step's executable instead of compiling again."""
        import jax
        import jax.numpy as jnp

        Tc = jnp.zeros((self.ne, self.D), dtype=self.dtype)
        Tv = jnp.zeros((self.ne_tv,), dtype=self.dtype)
        if self._dir_sharding is None:
            return Tc, Tv
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = NamedSharding(self._dir_sharding.mesh, P())
        return jax.device_put(Tc, rep), jax.device_put(Tv, rep)

    # -- one outer iteration ----------------------------------------------

    def _level_a_inv(self, c, mass_l, g_mat_l):
        """On-the-fly A^-1 for ONE level's elements (OnTheFly analog): invert
        only the (Km, BS, W) blocks inside the scan body, so nothing is
        stored — ~40x less memory than the full cache at D^3/D^2 extra flops
        per step, which bandwidth-bound shapes absorb.

        mass_l (D, D, W), g_mat_l (Km, D, D, W) -> (Km, BS, D, D, W)."""
        import jax.numpy as jnp

        A = (
            jnp.moveaxis(mass_l, -1, 0)[None, None]
            + c["vg"][None, :, None, None, None]
            * jnp.moveaxis(g_mat_l, -1, 1)[:, None]
        )  # (Km, BS, W, D, D)
        return jnp.moveaxis(jnp.linalg.inv(A), 2, -1)

    def _step_impl(self, c, u, Tc, Tv_prev):
        import jax
        import jax.numpy as jnp
        from jax import lax

        if self.sweep_mode == "ring":
            if self._ring_wd:
                return self._step_ring_wd(c, u, Tc, Tv_prev)
            if self._ring_windowed:
                return self._step_ring_win(c, u, Tc, Tv_prev)
            return self._step_ring(c, u, Tc, Tv_prev)

        G, W, L, nf, D = self.G, self.W, self.L, self.nf, self.D

        TcT = Tc.T  # (D, ne)

        # length of the element axis of u/operators: ne in compact mode,
        # L*W in padded mode (the H>4 Pallas fallback keeps padded layout)
        ne = self.ne_pad

        def _write(u_g, sol, offc):
            return lax.dynamic_update_slice_in_dim(u_g, sol, offc, axis=-1)

        def sweep_group(u_g, TcT_g, mass_t, face_int, coupling, nbr_pos, bc_T,
                        fdot, mats, g_mass, offsets_g, counts_g,
                        per_face, per_pos, per_src, per_cpl, per_valid,
                        *extra):
            # u_g (Km, BS, D, ne); compact group-level-concatenated order

            # ---- rhs base: everything that does not depend on the in-sweep
            # neighbor values. Hoisted over all elements when the
            # (G, Km, BS, D, ne) temporaries fit device memory (big matmuls, no
            # per-level overhead); otherwise only the BS-free pieces are
            # hoisted and the relaxation matmul moves into the level window
            # (the hoisted form OOM'd the legacy 16x24-angle tet shape:
            # 24 groups x 47 slots x 2 state-sized temporaries) ----
            ex = list(extra)
            dvec_gl = ex.pop(0) if self.has_dirichlet else None
            dif_pos_g = dif_con_g = spc_pos_g = spc_con_g = None
            if self._dif_on:
                dif_pos_g, dif_con_g = ex.pop(0), ex.pop(0)
            if self._spc_on:
                spc_pos_g, spc_con_g = ex.pop(0), ex.pop(0)

            cin_all = jnp.minimum(fdot, 0.0)  # (Km, nf, ne)
            is_b_all = nbr_pos < 0  # (nf, ne)
            cin_bnd_all = jnp.where(is_b_all[None], cin_all, 0.0)
            if self._scan_cls_ops:
                # class-compressed streams: mass_t/face_int args are dummies;
                # rebuild the (still-hoisted, BS-free) small terms by class
                # masking against the factor cache's one-hot (mats[1])
                oh_all = mats[1]  # (ncls, ne_pad)
                t_tc = None
                bsrc = None
                dsrc = None
                for ci in range(self.ncls):
                    t_c = jnp.einsum(
                        "ij,jE->iE", c["cls_massT"][ci], TcT_g
                    ) * oh_all[ci]
                    b_c = jnp.einsum(
                        "kfE,fE,fi->kiE",
                        cin_bnd_all, bc_T * oh_all[ci][None],
                        c["cls_fint"][ci],
                    )
                    t_tc = t_c if t_tc is None else t_tc + t_c
                    bsrc = b_c if bsrc is None else bsrc + b_c
                    if self.has_dirichlet:
                        # dvec_gl carries the SCALAR g per face here
                        d_c = jnp.einsum(
                            "kfE,fE,fi->kiE",
                            cin_bnd_all, dvec_gl * oh_all[ci][None],
                            c["cls_fint"][ci],
                        )
                        dsrc = d_c if dsrc is None else dsrc + d_c
            else:
                t_tc = jnp.einsum("ijE,jE->iE", mass_t, TcT_g)  # (D, ne)
                bsrc = jnp.einsum(
                    "kfE,fE,fiE->kiE", cin_bnd_all, bc_T, face_int
                )  # (Km, D, ne) — BS-free, cheap to keep hoisted
                if self.has_dirichlet:
                    dsrc = jnp.einsum("kfE,fiE->kiE", cin_bnd_all, dvec_gl)
                else:
                    dsrc = None
            if self._hoist_rhs:
                t_old = jnp.einsum(
                    "ijE,kbjE->kbiE", mass_t, u_g
                )  # (Km, BS, D, ne)
                rhs_base = (
                    c["src_w"][None, :, None, None] * t_tc[None, None]
                    + c["relax_w"][None, :, None, None] * t_old
                    - c["vg"][None, :, None, None]
                    * c["bc_w"][None, :, None, None]
                    * bsrc[:, None]
                )  # (Km, BS, D, ne)
                if dsrc is not None:
                    rhs_base = (
                        rhs_base - c["vg"][None, :, None, None] * dsrc[:, None]
                    )
            else:
                rhs_base = None  # assembled per level window instead
            cin_int_all = jnp.where(is_b_all[None], 0.0, cin_all)

            if self.has_periodic:
                # lagged periodic coupling: read the PREVIOUS iterate (u_g is
                # still the carry's initial value here) at the wrap partners
                # and fold into the rhs base — periodic faces are invisible
                # to the level scan (masked from nbr_pos / cin_int_all)
                u_src = u_g[:, :, :, per_src]  # (Km, BS, D, P)
                cin_p = (
                    jnp.minimum(fdot[:, per_face, per_pos], 0.0)
                    * per_valid[None]
                )  # (Km, P)
                contrib = jnp.einsum(
                    "pij,kp,kbjp->kbip", per_cpl, cin_p, u_src
                )  # (Km, BS, D, P)
                rhs_base = rhs_base.at[:, :, :, per_pos].add(
                    -c["vg"][None, :, None, None] * contrib
                )

            if dif_con_g is not None:
                # lagged diffuse (Lambert) incoming intensity, precomputed
                # from the full previous state outside the group vmap
                rhs_base = rhs_base.at[:, :, :, dif_pos_g].add(dif_con_g)
            if spc_con_g is not None:
                rhs_base = rhs_base.at[:, :, :, spc_pos_g].add(spc_con_g)

            def make_level_body(Ws):
                iota = jnp.arange(Ws)

                def level_body(u_g, oc):
                    off, count = oc
                    # clamp so the static-width window stays in bounds; slots
                    # outside [off, off+count) compute garbage that the masked
                    # write-back discards (earlier-level slots keep their
                    # final values; later-level slots are rewritten by their
                    # own step)
                    offc = jnp.minimum(off, ne - Ws)
                    shift = off - offc  # slots before `shift`: levels < l
                    sl = lambda a: lax.dynamic_slice_in_dim(a, offc, Ws, axis=-1)
                    u_e = sl(u_g)  # (Km, BS, D, Ws)
                    if self._hoist_rhs:
                        rhs = sl(rhs_base)
                    else:
                        # window-local rhs assembly (memory-tight problems:
                        # no (Km, BS, D, ne)-sized hoisted temporaries)
                        if self._scan_cls_ops:
                            # rebuild the window mass from the class cache
                            # (tiny ncls x Ws one-hot matmul, same trick as
                            # the class-full factor cache below)
                            ohw0 = lax.dynamic_slice_in_dim(
                                mats[1], offc, Ws, axis=-1)
                            mass_t_w = jnp.einsum(
                                "cij,cw->ijw", c["cls_massT"], ohw0,
                                precision=jax.lax.Precision.HIGHEST)
                        else:
                            mass_t_w = sl(mass_t)
                        t_old_w = jnp.einsum(
                            "ijw,kbjw->kbiw", mass_t_w, u_e
                        )
                        rhs = (
                            c["src_w"][None, :, None, None]
                            * sl(t_tc)[None, None]
                            + c["relax_w"][None, :, None, None] * t_old_w
                            - c["vg"][None, :, None, None]
                            * c["bc_w"][None, :, None, None]
                            * sl(bsrc)[:, None]
                        )
                        if dsrc is not None:
                            rhs = (
                                rhs
                                - c["vg"][None, :, None, None]
                                * sl(dsrc)[:, None]
                            )
                    # all faces fused: ONE neighbor gather + ONE coupling einsum
                    npos = sl(nbr_pos)  # (nf, Ws) neighbor position or -1
                    is_b = npos < 0  # boundary
                    u_nbr = u_g[:, :, :, jnp.where(is_b, 0, npos)]  # (Km,BS,D,nf,Ws)
                    if self._scan_cls_ops:
                        ohw0 = lax.dynamic_slice_in_dim(
                            mats[1], offc, Ws, axis=-1)
                        cpl_w = jnp.einsum(
                            "cfij,cw->fijw", c["cls_cpl"], ohw0,
                            precision=jax.lax.Precision.HIGHEST)
                    else:
                        cpl_w = sl(coupling)
                    interior = jnp.einsum(
                        "fijw,kfw,kbjfw->kbiw",
                        cpl_w, sl(cin_int_all), u_nbr,
                    )  # (Km, BS, D, Ws)
                    rhs = rhs - c["vg"][None, :, None, None] * interior
                    if self.cache_policy == "eigen":
                        # complex arithmetic via split real/imag parts
                        if len(mats) == 4:
                            # class mode: rebuild window factors from the
                            # per-class cache with a tiny one-hot matmul
                            # (no per-level HBM factor stream)
                            # HIGHEST precision: the default f32 einsum
                            # may round its operands (TF32 or bf16), and
                            # eigen factors (cond(V)~1e2) amplify that to
                            # O(1e-2) field error; the matmul is tiny
                            # (ncls x Ws) so full precision is free
                            ohw = lax.dynamic_slice_in_dim(
                                mats[3], offc, Ws, axis=-1)  # (ncls, Ws)
                            hi = jax.lax.Precision.HIGHEST
                            P_l = jnp.einsum(
                                "kzijc,cw->kzijw", mats[0], ohw, precision=hi)
                            Q_l = jnp.einsum(
                                "kzijc,cw->kzijw", mats[1], ohw, precision=hi)
                            lam_l = jnp.einsum(
                                "kzic,cw->kziw", mats[2], ohw, precision=hi)
                        else:
                            P_l = lax.dynamic_slice_in_dim(mats[0], offc, Ws, axis=-1)
                            Q_l = lax.dynamic_slice_in_dim(mats[1], offc, Ws, axis=-1)
                            lam_l = lax.dynamic_slice_in_dim(mats[2], offc, Ws, axis=-1)
                        # The eigen apply MUST NOT run with rounded (TF32 or
                        # bf16) operands: the V / V^-1 factor pair amplifies
                        # input rounding by cond(V) (~1.6e2 on flagship hex
                        # p=2 operators) into O(1e-2) absolute field error
                        # on a 0.38-max field, against ~1e-6 at HIGHEST.
                        hi = jax.lax.Precision.HIGHEST
                        t_re = jnp.einsum(
                            "kijw,kbjw->kbiw", Q_l[:, 0], rhs, precision=hi)
                        t_im = jnp.einsum(
                            "kijw,kbjw->kbiw", Q_l[:, 1], rhs, precision=hi)
                        vgb = c["vg"][None, :, None, None]
                        d_re = 1.0 + vgb * lam_l[:, None, 0]
                        d_im = vgb * lam_l[:, None, 1]
                        inv_mag = 1.0 / (d_re * d_re + d_im * d_im)
                        s_re = (t_re * d_re + t_im * d_im) * inv_mag
                        s_im = (t_im * d_re - t_re * d_im) * inv_mag
                        sol = (
                            jnp.einsum(
                                "kijw,kbjw->kbiw", P_l[:, 0], s_re,
                                precision=hi)
                            - jnp.einsum(
                                "kijw,kbjw->kbiw", P_l[:, 1], s_im,
                                precision=hi)
                        )
                        mine = (iota >= shift) & (iota < shift + count)
                        sol = jnp.where(mine[None, None, None, :], sol, u_e)
                        return _write(u_g, sol, offc), None
                    if self.cache_policy == "full" and isinstance(mats, tuple):
                        # class mode: rebuild the window inverses from the
                        # per-class cache with a tiny one-hot matmul (HIGHEST
                        # so the selection does not truncate the stored f32
                        # factors to bf16; the matmul is ncls x Ws — free)
                        ohw = lax.dynamic_slice_in_dim(
                            mats[1], offc, Ws, axis=-1)  # (ncls, Ws)
                        a_inv_l = jnp.einsum(
                            "kbijc,cw->kbijw", mats[0], ohw,
                            precision=jax.lax.Precision.HIGHEST)
                    elif self.cache_policy == "full":
                        a_inv_l = lax.dynamic_slice_in_dim(mats, offc, Ws, axis=-1)
                    else:
                        a_inv_l = self._level_a_inv(
                            c,
                            lax.dynamic_slice_in_dim(g_mass, offc, Ws, axis=-1),
                            lax.dynamic_slice_in_dim(mats, offc, Ws, axis=-1),
                        )
                    sol = jnp.einsum("kbijw,kbjw->kbiw", a_inv_l, rhs)
                    mine = (iota >= shift) & (iota < shift + count)
                    sol = jnp.where(mine[None, None, None, :], sol, u_e)
                    return _write(u_g, sol, offc), None

                return level_body

            # one scan per width segment (levels stay in topological order)
            for (l0, l1, Ws) in self.segments:
                u_g, _ = lax.scan(make_level_body(Ws), u_g,
                                  (offsets_g[l0:l1], counts_g[l0:l1]),
                                  unroll=self.scan_unroll)
            return u_g

        # per-group view of Tc in group-level order (padding reads element 0;
        # any garbage it produces lands on padded slots, which nothing reads)
        TcT_groups = jnp.moveaxis(TcT[:, c["perm"]], 1, 0)  # (G, D, ne)

        extra = (c["dvec"],) if self.has_dirichlet else ()
        # lagged reflective BCs (legacy types 2/3): closures over the
        # PREVIOUS iterate need cross-group reads, so they are computed
        # here (u is still the previous state) and scattered into each
        # group's hoisted rhs base inside sweep_group
        if self._dif_on:
            u_d = jax.vmap(lambda ug, pg: ug[:, :, :, pg])(
                u, c["dif_pos"]
            )  # (G, Km, BS, D, P)
            out_flux = jnp.einsum(
                "gkp,pi,gkbip->bp", c["dif_wplus"], c["dif_fint"], u_d
            )
            u_in = out_flux * c["dif_norm"][None, :]  # (BS, P)
            dif_con = -jnp.einsum(
                "gkp,b,bp,pi->gkbip",
                c["dif_cin"], c["vg"], u_in, c["dif_fint"],
            )
            extra = extra + (c["dif_pos"], dif_con)
        if self._spc_on:
            u_flat = u.reshape((u.shape[0] * u.shape[1],) + u.shape[2:])
            u_m = u_flat[c["spc_gk"], :, :, c["spc_src"]]  # (G, Km, P, BS, D)
            spc_con = -jnp.einsum(
                "gkp,b,pij,gkpbj->gkbip",
                c["spc_cin"], c["vg"], c["spc_fm"], u_m,
            )
            extra = extra + (c["spc_pos"], spc_con)
        group_args = (
            u, TcT_groups, c["mass_t"], c["face_int"], c["coupling"],
            c["nbr_pos"], c["bc_T"], c["fdot"], c["mats"], c["mass"],
            c["offsets"], c["counts"],
            c["per_face"], c["per_pos"], c["per_src"], c["per_cpl"],
            c["per_valid"], *extra,
        )
        if self._seq_groups:
            # memory-tight shapes: process direction groups sequentially —
            # the vmap materializes per-group working buffers for ALL G
            # groups at once (the on-the-fly batched inverse pads its
            # (..., D, D) minor dims to (8, 128) tiles: 3 x 6.6 GB at the
            # legacy 24-group tet shape)
            u = lax.map(lambda a: sweep_group(*a), group_args)
        else:
            u = jax.vmap(sweep_group)(*group_args)

        # macroscopic closure: per-group partials in group order -> global
        partial = jnp.einsum("gkb,gkbip->gip", c["macro_w"], u)  # (G, D, ne_pad)
        pos = c["pos_of_elem"]  # (G, ne)
        Tc_new = jax.vmap(lambda pg, po: pg[:, po])(partial, pos).sum(0).T  # (ne, D)
        Tv_new = self._tv_from_tc(c, Tc_new)
        res = macroscopic.residual(Tv_new, Tv_prev)
        return u, Tc_new, Tv_new, res

    def _step_ring_win(self, c, u, Tc, Tv_prev):
        """Hull-windowed lattice ring sweep: like the lattice branch of
        _step_ring, but every level processes only its ALIGNED hull window
        (self._ring_segs: per-segment static offset o0 and width Ws, both
        multiples of 128) instead of the full W = n1*n2 plane — at the
        hex-16^3 flagship that is 9.9k slots instead of 11.8k, and every
        per-level cost (dot, shift staging, ys write, const slicing) is
        slot-proportional.

        State u: tuple over Km buckets of tuples over segments of
        (L_s, G_b, Km_b, D, BS, Ws) slabs. Within a segment the upwind
        neighbor sits at the STATIC relative shift s_f (d = 0 for aligned
        windows); across segment boundaries the carry slab is re-windowed
        (tile-aligned static slice + zero pad) into the next segment's
        entry frame, whose hull coverage _fit_ring_window guarantees.
        Single-class lattice only (H = 1, no periodic wraps)."""
        import jax
        import jax.numpy as jnp
        from jax import lax

        G, D, BS = self.G, self.D, self.BS
        segs = self._ring_segs
        st = jnp.bfloat16 if self._ring_stage_bf16 else None
        hi_p = jax.lax.Precision.HIGHEST if self._sel_hi else None
        TcT = Tc.T  # (D, ne)

        def _shift(x, s):
            """y[w] = x[w - s] along the last axis, zero-filled."""
            if s == 0:
                return x
            Wl = x.shape[-1]
            if abs(s) >= Wl:
                return jnp.zeros_like(x)
            pads = [(0, 0)] * (x.ndim - 1)
            if s > 0:
                return jnp.pad(x[..., :-s], pads + [(s, 0)])
            return jnp.pad(x[..., -s:], pads + [(0, -s)])

        def _rewin(x, start, width):
            """x[..., start:start+width] with zero fill out of range."""
            Wl = x.shape[-1]
            lo2, hi2 = max(start, 0), min(start + width, Wl)
            if lo2 >= hi2:
                return jnp.zeros(x.shape[:-1] + (width,), x.dtype)
            pads = [(0, 0)] * (x.ndim - 1)
            return jnp.pad(
                x[..., lo2:hi2],
                pads + [(lo2 - start, start + width - hi2)],
            )

        def win_group(v_segs, cin_segs, bsrc_segs, pwin_segs, vwin_segs,
                      mats_g, macro_w_g, *extra):
            massT0 = mats_g[2][0]  # (D, D): single geometry class
            bcat = mats_g[4] if self._ring_fold else None
            km_b = mats_g[0].shape[1]
            dsrc_segs = extra[0] if extra else None

            carry = None
            prev_off_last = 0
            ys_out, ms_out = [], []
            for si, (l0, l1, o0, dlt, Ws) in enumerate(segs):
                rel = tuple(int(s) - dlt for s in self._ring_shift_vals)
                tc_s = (
                    jnp.transpose(TcT[:, pwin_segs[si]], (1, 0, 2))
                    * vwin_segs[si][:, None, :]
                )  # (L_s, D, Ws); padded slots zeroed (exact-zero fixed pts)
                ttc = jnp.einsum("ij,ljw->liw", massT0, tc_s)
                if carry is None:
                    carry = jnp.zeros(
                        (km_b, D, BS, Ws), st or v_segs[si].dtype
                    )
                else:
                    carry = _rewin(carry, (o0 - dlt) - prev_off_last, Ws)

                def make_body(rel):
                    def body(ring, xs):
                        v_l, ttc_l, bsrc_l, cin_l, dsrc_l = xs
                        rhs = (
                            c["src_w"][None, None, :, None]
                            * ttc_l[None, :, None]
                            + c["relax_w"][None, None, :, None] * v_l
                            - (c["vg"] * c["bc_w"])[None, None, :, None]
                            * bsrc_l[:, :, None]
                        )
                        if dsrc_l is not None:
                            rhs = (
                                rhs
                                - c["vg"][None, None, :, None]
                                * dsrc_l[:, :, None]
                            )
                        parts = [] if bcat is None else [
                            rhs.astype(st) if st else rhs
                        ]
                        for fi, s in enumerate(rel):
                            unf = (
                                _shift(ring, s)
                                * cin_l[fi][:, None, None, :]
                            )
                            parts.append(unf.astype(st) if st else unf)
                        if bcat is not None:
                            xcat = jnp.concatenate(parts, axis=1)
                            if st:
                                sol = jnp.einsum(
                                    "kbiJ,kJbw->kibw", bcat, xcat,
                                    preferred_element_type=jnp.float32,
                                )
                            else:
                                sol = jnp.einsum(
                                    "kbiJ,kJbw->kibw", bcat, xcat,
                                    precision=hi_p,
                                )
                        else:
                            # two-matmul supercell variant (see _step_ring)
                            stack = jnp.stack(parts, axis=1)
                            cc = mats_g[3].astype(stack.dtype)
                            term = jnp.einsum(
                                "fij,kfjbw->kibw", cc, stack,
                                preferred_element_type=rhs.dtype,
                                precision=hi_p,
                            )
                            rhs2 = rhs - c["vg"][None, None, :, None] * term
                            sol = jnp.einsum(
                                "kbij,kjbw->kibw", mats_g[0][0], rhs2,
                                precision=hi_p,
                            )
                        m_l = jnp.einsum("kb,kibw->iw", macro_w_g, sol, precision=hi_p)
                        sol_c = sol.astype(st) if st else sol
                        return sol_c, (
                            sol_c if self._ring_state_bf16 else sol, m_l
                        )

                    return body

                xs = (
                    v_segs[si], ttc, bsrc_segs[si], cin_segs[si],
                    dsrc_segs[si] if dsrc_segs is not None else None,
                )
                carry, (ys, ms) = lax.scan(
                    make_body(rel), carry, xs, unroll=self.scan_unroll
                )
                prev_off_last = o0 + dlt * (l1 - 1 - l0)
                ys_out.append(ys)
                ms_out.append(ms)
            return tuple(ys_out), tuple(ms_out)

        m_parts = []
        v_new = []
        for bi, (gs, km_b) in enumerate(self._ring_buckets):
            cb = c["ring_b"][bi]
            mats_b = c["mats"][bi]
            sd = cb["segs"]
            args = (
                u[bi],
                tuple(s["cin"] for s in sd),
                tuple(s["bsrc0"] for s in sd),
                tuple(s["pwin"] for s in sd),
                tuple(s["vwin"] for s in sd),
                mats_b,
                cb["macro_w"],
            )
            extra = (
                (tuple(s["dsrc0"] for s in sd),)
                if self.has_dirichlet
                else ()
            )
            mats_axes = tuple(
                1 if i == 1 else 0 for i in range(len(mats_b))
            )
            vb, mb = jax.vmap(
                win_group,
                in_axes=(1, 1, 1, 1, 1, mats_axes, 0)
                + ((1,) if self.has_dirichlet else ()),
                out_axes=(1, 0),
            )(*args, *extra)
            v_new.append(vb)
            m_parts.append(mb)

        # macroscopic closure per segment (each element lives in exactly
        # one segment; the masked gathers sum disjoint contributions)
        order = np.concatenate([gs for gs, _ in self._ring_buckets])
        inv_order = np.empty(G, dtype=np.int32)
        inv_order[order] = np.arange(G)
        Tc_v = jnp.zeros((self.ne, D), dtype=Tc.dtype)
        for si in range(len(segs)):
            m_cat = jnp.concatenate(
                [m_parts[bi][si] for bi in range(len(m_parts))], axis=0
            )[inv_order]  # (G, L_s, D, Ws)
            part = jnp.transpose(m_cat, (0, 2, 1, 3)).reshape(G, D, -1)
            po = c["ring_pos_win"][si]  # (G, ne), -1 outside this segment
            got = jax.vmap(
                lambda pg, po_: jnp.where(
                    po_ >= 0, pg[:, jnp.clip(po_, 0)], 0.0
                )
            )(part, po)
            Tc_v = Tc_v + got.sum(0).T
        Tc_new = jnp.einsum("eij,ej->ei", c["ring_invMT"], Tc_v, precision=hi_p)
        Tv_new = self._tv_from_tc(c, Tc_new)
        res = macroscopic.residual(Tv_new, Tv_prev)
        return tuple(v_new), Tc_new, Tv_new, res

    def _step_ring_wd(self, c, u, Tc, Tv_prev):
        """Supercell ring step in the WD layout: state is a tuple of
        per-bucket (L, G_b, Km_b, BS, W, D') arrays with the super-DOF axis
        MINOR and the small macro plane W next to it — see the layout
        rationale at the _ring_wd decision in __init__. Two-matmul body:
        the geometry-only coupling C applies as one
        (D', nf*D') x (nf*D', Km*BS*W) GEMM, the per-(k,b) factor B as a
        (W, D') x (D', D') batched GEMM."""
        import jax
        import jax.numpy as jnp
        from jax import lax

        G, W, L, D, BS = self.G, self.W, self.L, self.D, self.BS
        hi_p = jax.lax.Precision.HIGHEST if self._sel_hi else None
        st = jnp.bfloat16 if self._ring_stage_bf16 else None

        TcT = Tc.T  # (D, ne)
        # (L, G, W, D) lagged-temperature slab; padded slots zeroed
        tc_slab = (
            jnp.transpose(TcT[:, c["perm"]].reshape(D, G, L, W), (2, 1, 3, 0))
            * c["valid_slab"][:, :, :, None]
        )

        def ring_group(v_g, tc_g, bsrc0_g, cin_g, mats_g, macro_w_g):
            # v_g (L, Km_b, BS, W, D); tc_g (L, W, D); bsrc0_g (L, Km, W, D)
            b_cls, massT_c = mats_g[0], mats_g[2]
            ccpl_gl = mats_g[3]  # (nf_act, D, D)
            # t_tc[l, w, i] = sum_j massT[i, j] tc[l, w, j]
            t_tc = jnp.einsum(
                "ij,lwj->lwi", massT_c[0], tc_g, precision=hi_p
            )

            def body(ring, xs):
                v_l, ttc_l, bsrc_l, cin_l = xs
                rhs = (
                    c["src_w"][None, :, None, None] * ttc_l[None, None]
                    + c["relax_w"][None, :, None, None] * v_l
                    - (c["vg"] * c["bc_w"])[None, :, None, None]
                    * bsrc_l[:, None]
                )
                parts = []
                for fi, s in enumerate(self._ring_shift_vals):
                    yf = ring
                    if s:
                        yf = jnp.pad(
                            yf[..., :-s, :],
                            ((0, 0), (0, 0), (s, 0), (0, 0)),
                        )
                    unf = yf * cin_l[fi][:, None, :, None]
                    parts.append(unf.astype(st) if st else unf)
                stack = jnp.stack(parts, axis=1)  # (Km, nf, BS, W, D)
                cc = ccpl_gl.astype(stack.dtype)
                term = jnp.einsum(
                    "fij,kfbwj->kbwi", cc, stack,
                    preferred_element_type=rhs.dtype,
                    precision=hi_p,
                )
                rhs = rhs - c["vg"][None, :, None, None] * term
                sol = jnp.einsum(
                    "kbij,kbwj->kbwi", b_cls[0], rhs, precision=hi_p
                )
                m_l = jnp.einsum("kb,kbwi->wi", macro_w_g, sol, precision=hi_p)
                sol_c = (
                    sol.astype(ring.dtype)
                    if sol.dtype != ring.dtype else sol
                )
                return sol_c, (
                    sol_c if self._ring_state_bf16 else sol, m_l
                )

            Km_b = v_g.shape[1]
            ring0 = jnp.zeros(
                (Km_b, BS, W, D), st if st else v_g.dtype
            )
            _, (ys, ms) = lax.scan(
                body, ring0, (v_g, t_tc, bsrc0_g, cin_g),
                unroll=self.scan_unroll,
            )
            return ys, ms  # (L, Km_b, BS, W, D), (L, W, D)

        m_parts = []
        v_new = []
        for bi, (gs, km_b) in enumerate(self._ring_buckets):
            cb = c["ring_b"][bi]
            # cin arrives (L, G_b, nf_act, Km_b, W); the body wants
            # (L, nf_act, Km_b, W) per group with nf leading after vmap
            cin_b = cb["cin"]
            vb, mb = jax.vmap(
                ring_group,
                in_axes=(1, 1, 1, 1, tuple(
                    1 if i == 1 else 0 for i in range(len(c["mats"][bi]))
                ), 0),
                out_axes=(1, 0),
            )(
                u[bi], tc_slab[:, gs], cb["bsrc0"], cin_b,
                c["mats"][bi], cb["macro_w"],
            )
            v_new.append(vb)
            m_parts.append(mb)

        order = np.concatenate([gs for gs, _ in self._ring_buckets])
        inv_order = np.empty(G, dtype=np.int32)
        inv_order[order] = np.arange(G)
        m_cat = jnp.concatenate(m_parts, axis=0)[inv_order]  # (G, L, W, D)
        partial = jnp.transpose(
            m_cat.reshape(G, self.ne_pad, D), (0, 2, 1)
        )  # (G, D, ne_pad)
        pos = c["pos_of_elem"]  # (G, ne)
        Tc_v = jax.vmap(lambda pg, po: pg[:, po])(partial, pos).sum(0).T
        Tc_new = jnp.einsum("eij,ej->ei", c["ring_invMT"], Tc_v, precision=hi_p)
        Tv_new = self._tv_from_tc(c, Tc_new)
        res = macroscopic.residual(Tv_new, Tv_prev)
        return tuple(v_new), Tc_new, Tv_new, res

    def _step_ring(self, c, u, Tc, Tv_prev):
        """Ring sweep step on the bucketed slab-major state: u is a tuple of
        per-Km-bucket arrays (L, G_b, Km_b, D, BS, W) — see _ring_buckets.

        Everything is L-LEADING: the scan's xs arrays slice natively, the
        per-level solutions stack natively into the next state (ys), and no
        transposes of the 3GB state remain (a (Km,BS,D,L*W)-major variant
        pays a full layout copy of the state every step)."""
        import jax
        import jax.numpy as jnp
        from jax import lax

        G, W, L, nf, D = self.G, self.W, self.L, self.nf, self.D
        BS = self.BS
        ncls = self.ncls_ring
        Hn = self._ring_H
        # selective precision: exact passes on the transport contractions
        hi_p = jax.lax.Precision.HIGHEST if self._sel_hi else None

        TcT = Tc.T  # (D, ne)
        # (L, G, D, W) slab view of the lagged temperature (tiny array);
        # padded slots are zeroed so they stay exactly-zero fixed points of
        # the iteration (see consts["valid_slab"])
        tc_slab = (
            jnp.transpose(TcT[:, c["perm"]].reshape(D, G, L, W), (2, 1, 0, 3))
            * c["valid_slab"][:, :, None, :]
        )
        slot_off = (jnp.arange(L, dtype=jnp.int32) % Hn) * W

        # ---- lagged reflective closures (legacy types 2/3) -----------------
        # Cross-group reads of the PREVIOUS iterate (u is still the previous
        # state here): gather v at every reflective boundary element's slab
        # (level, slot) per group, dense over (G, Km) so the diffuse
        # hemisphere flux sums all outgoing directions and the specular
        # mirror direction can live in any group; the M^-T that converts the
        # carried v = M^T u back to physical traces is folded into
        # dif_fvec / spc_fmv at setup. Contributions scatter into each
        # group's rhs_extra inside ring_group (same mechanism as periodic).
        refl_con = None
        if self._ring_refl is not None:
            f32 = tc_slab.dtype
            parts = []
            for bi, (gs, km_b) in enumerate(self._ring_buckets):
                rb = c["ring_b"][bi]
                gi = jnp.arange(len(gs))[:, None]
                vb = u[bi][
                    rb["refl_pl"], gi, :, :, :, rb["refl_pw"]
                ]  # (G_b, P, Km_b, D, BS)
                vb = jnp.moveaxis(vb, 1, -1)  # (G_b, Km_b, D, BS, P)
                if km_b < self.Km:
                    vb = jnp.pad(
                        vb,
                        ((0, 0), (0, self.Km - km_b), (0, 0), (0, 0), (0, 0)),
                    )
                parts.append(vb)
            r_order = np.concatenate([gs for gs, _ in self._ring_buckets])
            r_inv = np.empty(G, dtype=np.int32)
            r_inv[r_order] = np.arange(G)
            v_bnd = jnp.concatenate(parts, axis=0)[r_inv].astype(
                f32
            )  # (G, Km, D, BS, P)
            pd = self._ring_refl_Pd
            cons = []
            if self._dif_on:
                out_flux = jnp.einsum(
                    "gkp,pj,gkjbp->bp",
                    c["dif_wplus"], c["dif_fvec"], v_bnd[..., :pd],
                )
                u_in = out_flux * c["dif_norm"][None]  # (BS, P_d)
                cons.append(-jnp.einsum(
                    "gkp,b,bp,pi->gpkib",
                    c["dif_cin"], c["vg"], u_in, c["dif_fint"],
                ))
            if self._spc_on:
                v_s = v_bnd[..., pd:]  # (G, Km, D, BS, P_s)
                v_sf = v_s.reshape((G * self.Km,) + v_s.shape[2:])
                p_idx = jnp.arange(v_s.shape[-1])[None, None, :]
                v_m = v_sf[c["spc_gk"], :, :, p_idx]  # (G, Km, P_s, D, BS)
                cons.append(-jnp.einsum(
                    "gkp,b,pij,gkpjb->gpkib",
                    c["spc_cin"], c["vg"], c["spc_fmv"], v_m,
                ))
            refl_con = jnp.concatenate(cons, axis=1)  # (G, P, Km, D, BS)

        def ring_group(v_g, tc_g, bsrc0_g, cin_g, oh_g, mats_g, macro_w_g,
                       per_cpl, per_cin, per_pl, per_pw, per_sl, per_sw,
                       cpl_slab, *extra):
            # v_g (L, Km_b, D, BS, W): the MASS-TRANSFORMED state v = M^T u.
            # The pseudo-time term is then relax*v (no per-step mass
            # matmul), the apply factor is B = M^T A^-1, and M^-T is folded
            # into every neighbor coupling at setup.
            b_cls, cls_oh, massT_c = mats_g[0], mats_g[1], mats_g[2]

            # lagged-temperature term (tiny: (L, D, W))
            t_tc = jnp.einsum(
                "ij,ljw->liw", massT_c[0], tc_g, precision=hi_p
            )
            if ncls > 1:
                t_tc = t_tc * cls_oh[:, 0][:, None, :]
                for ci in range(1, ncls):
                    t_tc = t_tc + cls_oh[:, ci][:, None, :] * jnp.einsum(
                        "ij,ljw->liw", massT_c[ci], tc_g
                    )
            # u-independent per-level rhs pieces, (L, Km, BS, D, W) folded
            # lazily in the body (only (L,Km,D,W)-sized consts live in HBM)
            ex = list(extra)
            dsrc0_g = ex.pop(0) if self.has_dirichlet else None  # (L,Km,D,W)
            if self._ring_refl is not None:
                refl_pl_g, refl_pw_g, refl_con_g = (
                    ex.pop(0), ex.pop(0), ex.pop(0)
                )

            # periodic: lagged wrap couplings against the previous iterate,
            # materialized as a sparse rhs addition (periodic meshes only)
            rhs_extra = None
            if self.has_periodic:
                v_src = v_g[per_sl, :, :, :, per_sw]  # (P, Km_b, D, BS)
                contrib = jnp.einsum(
                    "pij,kp,pkjb->pkib", per_cpl, per_cin, v_src
                )
                rhs_extra = jnp.zeros(
                    (L, v_g.shape[1], D, BS, W), v_g.dtype
                ).at[per_pl, :, :, :, per_pw].add(
                    -contrib * c["vg"][None, None, None, :]
                )

            # reflective: contributions precomputed outside (cross-group
            # reads), scattered here at this group's (level, slot) pairs;
            # corner elements with several reflective faces accumulate
            if self._ring_refl is not None:
                if rhs_extra is None:
                    rhs_extra = jnp.zeros(
                        (L, v_g.shape[1], D, BS, W), v_g.dtype
                    )
                rhs_extra = rhs_extra.at[refl_pl_g, :, :, :, refl_pw_g].add(
                    refl_con_g.astype(rhs_extra.dtype)
                )

            def body(ring, xs):
                # state/rhs/sol axis order is (Km, D, BS, W): XLA's chosen
                # internal layout for the scan buffers is W,BS,D minor-to-
                # major, so this ordering makes the row-major default match
                # (no relayout copies at the jit boundary)
                v_l, ttc_l, bsrc_l, oh_l, cin_l, coh_l, off, cpl_l, ex_l = xs
                rhs = (
                    c["src_w"][None, None, :, None] * ttc_l[None, :, None]
                    + c["relax_w"][None, None, :, None] * v_l
                    - (c["vg"] * c["bc_w"])[None, None, :, None]
                    * bsrc_l[:, :, None]
                    + ex_l
                )
                if (
                    self._ring_lattice and self._ring_ccpl
                    and self._ring_fold
                ):
                    # static shift selection (lattice meshes), FOLDED +
                    # CONCATENATED form:
                    #   sol = [B | -vg B C_0 | ...] @ [rhs; un_0; un_1; ...]
                    # with un_f = shift_{s_f}(ring) * cin_f. ONE matmul
                    # with contraction (1+nf_act)*D = 108 per level instead
                    # of separate small 27-contraction batched matmuls.
                    #
                    # bf16 STAGING (self._ring_stage_bf16): the carry and the
                    # xcat buffer are stored bf16 — it halves the dominant
                    # staging traffic (xcat write+read + 3 shifted carry
                    # reads) at the cost of one bf16 rounding of the dot's
                    # operands (see the _ring_stage_bf16 decision). Products
                    # are computed in f32 (bf16 carry upcast in registers)
                    # and rounded once on store.
                    bcat = mats_g[4]  # (Km, BS, D, (1+nf_act)*D)
                    st = (
                        jnp.bfloat16 if self._ring_stage_bf16 else None
                    )
                    parts = [rhs.astype(st) if st else rhs]
                    for fi, s in enumerate(self._ring_shift_vals):
                        yf = ring
                        if s:
                            yf = jnp.pad(
                                yf[..., :-s],
                                ((0, 0), (0, 0), (0, 0), (s, 0)),
                            )
                        unf = yf * cin_l[fi][:, None, None, :]
                        parts.append(unf.astype(st) if st else unf)
                    xcat = jnp.concatenate(parts, axis=1)
                    if st:
                        sol = jnp.einsum(
                            "kbiJ,kJbw->kibw", bcat, xcat,
                            preferred_element_type=jnp.float32,
                        )
                    else:
                        sol = jnp.einsum(
                            "kbiJ,kJbw->kibw", bcat, xcat, precision=hi_p
                        )
                    # fused macroscopic partial: read sol while it is hot
                    m_l = jnp.einsum("kb,kibw->iw", macro_w_g, sol, precision=hi_p)
                    sol_c = sol.astype(st) if st else sol
                    if Hn == 1:
                        ring = sol_c
                    else:
                        ring = lax.dynamic_update_slice_in_dim(
                            ring, sol_c, off, axis=-1
                        )
                    # bf16 state: emit the already-rounded sol_c as the ys
                    # (the m_l macro partial above reads the f32 sol)
                    return ring, (
                        sol_c if self._ring_state_bf16 else sol, m_l
                    )
                if self._ring_lattice and self._ring_ccpl:
                    # TWO-MATMUL supercell variant (no folded bcat — it is
                    # (1+dim)*gsz times B at D' = gsz*D): the class coupling
                    # C is GEOMETRY-ONLY, so one (D', nf_act*D') GEMM with
                    # (Km*BS*W)-wide free dims applies every neighbor term
                    # as one large matmul, then the per-(k,b) factor B
                    # applies through the shared tail below.
                    st = (
                        jnp.bfloat16 if self._ring_stage_bf16 else None
                    )
                    parts = []
                    for fi, s in enumerate(self._ring_shift_vals):
                        yf = ring
                        if s:
                            yf = jnp.pad(
                                yf[..., :-s],
                                ((0, 0), (0, 0), (0, 0), (s, 0)),
                            )
                        unf = yf * cin_l[fi][:, None, None, :]
                        parts.append(unf.astype(st) if st else unf)
                    stack = jnp.stack(parts, axis=1)  # (Km,nf_act,D,BS,W)
                    cc = mats_g[3].astype(stack.dtype)
                    term = jnp.einsum(
                        "fij,kfjbw->kibw", cc, stack,
                        preferred_element_type=rhs.dtype,
                        precision=hi_p,
                    )
                elif self._ring_lattice:
                    # multi-class lattice: per-element couplings applied to
                    # the unshifted ring (matrices pre-shifted at setup so
                    # out[w] = C[w] @ ring[w-s]), outputs shifted + masked
                    y = jnp.einsum(
                        "fijv,kjbv->kfibv", cpl_l, ring
                    ).reshape(ring.shape[0], -1, BS, W)
                    term = None
                    for fi, s in enumerate(self._ring_shift_vals):
                        yf = y[:, fi * D : (fi + 1) * D]
                        if s:
                            yf = jnp.pad(
                                yf[..., :-s],
                                ((0, 0), (0, 0), (0, 0), (s, 0)),
                            )
                        # cin is a per-(k, w) diagonal: commutes with the
                        # coupling matmul, applied on the (shifted) output
                        t = yf * cin_l[fi][:, None, None, :]
                        term = t if term is None else term + t
                else:
                    # batched per-face one-hot selection from the ring
                    # (emitting with (f,d) adjacent to feed a merged
                    # (D, nf*D) coupling dot measured slower where it was
                    # first built: the selection matmul pays more than the
                    # coupling saves)
                    un = jnp.einsum("kdbv,fvw->fkdbw", ring, oh_l)
                    unc = un * cin_l[:, :, None, None, :]  # (nf,Km,D,BS,W)
                    if self._ring_ccpl:
                        term = jnp.einsum("fij,fkjbw->kibw", mats_g[3], unc)
                    else:
                        term = jnp.einsum("fijw,fkjbw->kibw", cpl_l, unc)
                rhs = rhs - c["vg"][None, None, :, None] * term
                if ncls == 1:
                    sol = jnp.einsum(
                        "kbij,kjbw->kibw", b_cls[0], rhs, precision=hi_p
                    )
                else:
                    sol = jnp.einsum(
                        "ckbij,kjbw,cw->kibw", b_cls, rhs, coh_l,
                        precision=hi_p,
                    )
                # fused macroscopic partial: read sol while it is hot
                m_l = jnp.einsum("kb,kibw->iw", macro_w_g, sol, precision=hi_p)
                # bf16 staging (two-matmul variant): the carry stays bf16
                sol_c = (
                    sol.astype(ring.dtype)
                    if sol.dtype != ring.dtype else sol
                )
                if Hn == 1:
                    ring = sol_c
                else:
                    ring = lax.dynamic_update_slice_in_dim(
                        ring, sol_c, off, axis=-1
                    )
                return ring, (
                    sol_c if self._ring_state_bf16 else sol, m_l
                )

            Km_b = v_g.shape[1]
            ring0 = jnp.zeros(
                (Km_b, D, BS, Hn * W),
                jnp.bfloat16 if self._ring_stage_bf16 else v_g.dtype,
            )
            xs = (
                v_g, t_tc, bsrc0_g, oh_g, cin_g, cls_oh, slot_off, cpl_slab,
                rhs_extra if rhs_extra is not None
                else jnp.zeros((L, 1, 1, 1, 1), v_g.dtype),
            )
            if dsrc0_g is not None:
                def body_d(ring, xs):
                    (v_l, ttc_l, bsrc_l, oh_l, cin_l, coh_l, off, cpl_l,
                     ex_l, dsrc_l) = xs
                    inner_xs = (
                        v_l, ttc_l, bsrc_l, oh_l, cin_l, coh_l, off, cpl_l,
                        ex_l
                        - c["vg"][None, None, :, None] * dsrc_l[:, :, None],
                    )
                    return body(ring, inner_xs)
                _, (ys, ms) = lax.scan(
                    body_d, ring0, xs + (dsrc0_g,), unroll=self.scan_unroll
                )
            else:
                _, (ys, ms) = lax.scan(
                    body, ring0, xs, unroll=self.scan_unroll
                )
            return ys, ms  # (L,Km_b,D,BS,W), (L,D,W)

        # state and all L-indexed consts are stored L-MAJOR (L, G_b, ...)
        # and vmapped over axis 1: the scan then slices contiguous leading-
        # axis slabs — a G-major state costs a full relayout copy of the
        # state inside every step. One vmap per Km BUCKET
        # (groups with fewer direction slots run with exactly that many —
        # a uniform vmap padded every group to the max, 25% pure waste on
        # the hex flagship's [10,10,10,10,6,6,6,6] octants).
        m_parts = []
        v_new = []
        for bi, (gs, km_b) in enumerate(self._ring_buckets):
            cb = c["ring_b"][bi]
            mats_b = c["mats"][bi]
            cpl_slab = cb.get("cpl")
            if cpl_slab is None:
                cpl_slab = jnp.zeros((L, len(gs), 1), dtype=u[bi].dtype)
            extra = (cb["dsrc0"],) if self.has_dirichlet else ()
            ex_ax = (1,) if self.has_dirichlet else ()
            if refl_con is not None:
                extra = extra + (
                    cb["refl_pl"], cb["refl_pw"],
                    refl_con[gs][:, :, :km_b],  # (G_b, P, Km_b, D, BS)
                )
                ex_ax = ex_ax + (0, 0, 0)
            mats_axes = tuple(
                1 if i == 1 else 0 for i in range(len(mats_b))
            )
            vb, mb = jax.vmap(
                ring_group,
                in_axes=(1, 1, 1, 1, 1, mats_axes, 0, 0, 0, 0, 0, 0, 0, 1)
                + ex_ax,
                out_axes=(1, 0),
            )(
                u[bi], tc_slab[:, gs], cb["bsrc0"], cb["cin"],
                # lattice mode has no one-hot tables; feed a tiny dummy so
                # the traced xs structure stays uniform
                cb.get(
                    "oh",
                    jnp.zeros((L, len(gs), 1, 1, 1), dtype=u[bi].dtype),
                ),
                mats_b, cb["macro_w"], cb["per_cpl"], cb["per_cin"],
                cb["per_pl"], cb["per_pw"], cb["per_sl"], cb["per_sw"],
                cpl_slab, *extra,
            )
            v_new.append(vb)
            m_parts.append(mb)

        # macroscopic closure from the fused in-scan partials (saves a
        # separate re-read of the whole state); reassemble the
        # bucket partials into global group order
        order = np.concatenate([gs for gs, _ in self._ring_buckets])
        inv_order = np.empty(G, dtype=np.int32)
        inv_order[order] = np.arange(G)
        m_cat = jnp.concatenate(m_parts, axis=0)[inv_order]  # (G, L, D, W)
        partial = jnp.transpose(m_cat, (0, 2, 1, 3)).reshape(
            G, D, self.ne_pad
        )
        pos = c["pos_of_elem"]  # (G, ne)
        Tc_v = jax.vmap(lambda pg, po: pg[:, po])(partial, pos).sum(0).T
        # v = M^T u  =>  Tc_u[e] = M_e^-T Tc_v[e]
        Tc_new = jnp.einsum("eij,ej->ei", c["ring_invMT"], Tc_v, precision=hi_p)
        Tv_new = self._tv_from_tc(c, Tc_new)
        res = macroscopic.residual(Tv_new, Tv_prev)
        return tuple(v_new), Tc_new, Tv_new, res

    def _tv_from_tc(self, c, Tc_new):
        """Cell-average temperatures for the residual. Supercell problems
        reduce per FINE element (the reference's residual is over
        per-element averages, ref: src/MacroscopicQuantities.cpp:130-166);
        otherwise the plain basis-integral contraction."""
        import jax.numpy as jnp

        if self._super is not None:
            sc = self._super
            tvc = jnp.einsum(
                "egi,egi->eg",
                Tc_new.reshape(sc.ncell, sc.gsz, sc.D),
                c["super_basis"],
            )
            return (
                jnp.zeros((sc.ne_fine,), Tc_new.dtype)
                .at[c["super_scat"]]
                .set(tvc.reshape(-1))
            )
        return macroscopic.compute_tv(Tc_new, c["basis_int_glob"])

    def Tc_fine(self, Tc):
        """Per-(fine-)element temperature coefficients (ne, D). Identity on
        non-supercell problems; de-blocks (ncell, gsz*D) otherwise."""
        Tc = np.asarray(Tc)
        if self._super is None:
            return Tc
        sc = self._super
        out = np.zeros((sc.ne_fine, sc.D), Tc.dtype)
        out[sc.scatter_fine()] = Tc.reshape(sc.ncell * sc.gsz, sc.D)
        return out

    # -- outer loop ---------------------------------------------------------

    def step(self, u, Tc, Tv_prev):
        """One outer iteration: returns (u, Tc, Tv, residual)."""
        return self._step(self.consts, u, Tc, Tv_prev)

    def solve(
        self,
        tol: float = 1e-7,
        max_iter: int = 101,
        state=None,
        verbose: bool = True,
        callback=None,
        check_every: int = 1,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 25,
        accelerate: str | None = None,
        cycle_hook=None,
        cycle_every: int = 0,
        polish_iters: int = 0,
        polish_precision: str = "highest",
        polish_extrapolate: bool = False,
    ):
        """Outer source iteration (ref: src/PBTESolver.cpp:208-332).

        check_every > 1 amortizes host synchronization: the residual is still
        computed on device every iteration, but only fetched (and tested
        against tol) every `check_every` iterations. checkpoint_path writes a
        resumable .npz every checkpoint_every iterations (io.checkpoint).

        accelerate="bicgstab" solves the SAME fixed point as a linear system
        (I - A) x = b with BiCGStab whose matvec is one plain step — measured
        ~7x fewer step applications to tolerance (see solver/accel.py for
        the spectrum analysis and method comparison). `tol` is then the
        linear relative-residual target; the returned SolveResult carries
        the reference-style Tv residual of one final plain step, and
        `iterations` counts step applications (matvecs) so throughput
        comparisons stay apples-to-apples."""
        if accelerate not in (None, "none", "bicgstab", "compensated"):
            raise ValueError(f"unknown accelerate={accelerate!r}")
        if accelerate == "bicgstab":
            return self._solve_bicgstab(
                tol, max_iter, state, verbose, callback, check_every,
                checkpoint_path, checkpoint_every,
            )
        if accelerate == "compensated":
            # double-f32 state via TwoSum over the affine step — the
            # field-precision mode (accel.compensated_outer); two step
            # applications per outer iteration
            from pbte.solver import accel as _accel

            if getattr(self, "_ring_state_bf16", False):
                raise ValueError(
                    "accelerate='compensated' needs exact-dtype state; "
                    "unset PBTE_RING_STATE_BF16"
                )

            def _step_nd(u_, Tc_, Tv_):
                return self._step_plain(self.consts, u_, Tc_, Tv_)

            u_f, Tc_f, Tv_f, tv_res, nst = _accel.compensated_outer(
                _step_nd, self.initial_state(), state, tol, max_iter,
                verbose=verbose, callback=callback,
                check_every=check_every,
            )
            return SolveResult(u=u_f, Tc=Tc_f, Tv=Tv_f, residual=tv_res,
                               iterations=nst, solver=self)
        u, Tc, Tv = state if state is not None else self.initial_state()
        prev_Tv = Tv
        res = float("inf")
        it = 0
        for it in range(1, max_iter + 1):
            u, Tc_new, Tv_new, res_dev = self.step(u, Tc, prev_Tv)
            if it % check_every == 0 or it == max_iter:
                res = float(res_dev)
                if verbose:
                    print(f"[pbte] iter {it}, residual = {res:.6e}")
                if callback is not None:
                    callback(it, res)
                if res < tol:
                    Tc, prev_Tv = Tc_new, Tv_new
                    break
            prev_Tv = Tv_new
            Tc = Tc_new
            if cycle_hook and cycle_every > 0 and it % cycle_every == 0:
                # field-output cadence (ParaView collection cycles etc.);
                # receives the live device state
                cycle_hook(it, u, Tc, prev_Tv)
            if checkpoint_path and it % checkpoint_every == 0:
                from pbte.io.checkpoint import save_checkpoint

                save_checkpoint(checkpoint_path, self, u, Tc, prev_Tv, it,
                                res if np.isfinite(res) else float(res_dev))
        if polish_iters > 0:
            # PRECISION POLISH: the default-precision fixed point carries a
            # field bias from rounded matmul operands, amplified by
            # ~1/(1-rho); running N exact-precision iterations FROM the
            # converged default state contracts that bias by rho^N at a
            # fraction of the cost of converging at `highest` from zero.
            import jax as _jax

            prec = polish_precision

            def _polish_fn(c_, u_, Tc_, Tv_):
                with _jax.default_matmul_precision(prec):
                    return self._step_impl(c_, u_, Tc_, Tv_)

            polish_step = _jax.jit(_polish_fn)
            for _ in range(polish_iters):
                u, Tc, prev_Tv, res_dev = polish_step(
                    self.consts, u, Tc, prev_Tv
                )
                it += 1
            if polish_extrapolate:
                # GEOMETRIC-TAIL (Aitken) EXTRAPOLATION: the measured
                # default-precision field bias concentrates in quasi-neutral
                # modes (the global temperature-offset family, lambda ~= 1-
                # O(Kn/L)) that plain polish contracts at ~lambda^N, so a
                # few hundred exact steps remove little of it. After the
                # fast modes have decayed over the polish tail, successive
                # exact-step differences d_k are dominated by the slow
                # mode's geometric sequence; two more steps estimate its
                # ratio r and jump straight to the limit:
                #   x_inf ~= x2 + d2 * r / (1 - r).
                import jax.numpy as _jnp
                from pbte.solver.accel import tree_dot

                u1, Tc1, Tv1, _ = polish_step(self.consts, u, Tc, prev_Tv)
                u2, Tc2, Tv2, res_dev = polish_step(
                    self.consts, u1, Tc1, Tv1
                )
                it += 2
                d1 = Tc1 - Tc
                d2 = Tc2 - Tc1
                num = float(tree_dot(d2, d1))
                den = float(tree_dot(d1, d1)) + 1e-300
                r_m = min(max(num / den, 0.0), 0.99995)
                fac = r_m / (1.0 - r_m)
                Tc = Tc2 + fac * d2
                u = _jax.tree_util.tree_map(
                    lambda a2, a1: a2 + fac * (a2 - a1), u2, u1
                )
                prev_Tv = Tv2
                if verbose:
                    print(f"[pbte] polish extrapolation: mode ratio "
                          f"r = {r_m:.6f}, jump factor {fac:.1f}")
            res = float(res_dev)
            if verbose:
                print(f"[pbte] polish({prec}) x{polish_iters}: "
                      f"residual = {res:.6e}")
        return SolveResult(
            u=u, Tc=Tc, Tv=prev_Tv, residual=res, iterations=it, solver=self
        )

    def _solve_bicgstab(self, tol, max_iter, state, verbose, callback,
                        check_every, checkpoint_path, checkpoint_every):
        """Krylov-accelerated outer loop: BiCGStab on (I - A) x = b where
        one matvec = one plain step (accel.bicgstab_outer); `iterations`
        counts step applications so they compare with the plain loop."""
        from pbte.solver import accel

        if getattr(self, "_ring_state_bf16", False):
            raise ValueError(
                "accelerate='bicgstab' needs exact-dtype state recurrences; "
                "unset PBTE_RING_STATE_BF16"
            )
        save_ckpt = None
        if checkpoint_path:
            import jax.numpy as jnp

            from pbte.io.checkpoint import accel_ckpt_saver

            # build just the (ne,) Tv zeros leaf — initial_state() would
            # allocate the full multi-GB u tuple
            save_ckpt = accel_ckpt_saver(
                checkpoint_path, self,
                jnp.zeros((self.ne_tv,), dtype=self.dtype),
            )

        def step_fn(u, Tc, Tv_prev):
            return self._step_plain(self.consts, u, Tc, Tv_prev)

        u_f, Tc_f, Tv_f, tv_res, nmv = accel.bicgstab_outer(
            step_fn, self.initial_state(), state, tol, max_iter,
            verbose=verbose, callback=callback, check_every=check_every,
            save_ckpt=save_ckpt, ckpt_every=checkpoint_every,
        )
        return SolveResult(u=u_f, Tc=Tc_f, Tv=Tv_f, residual=tv_res,
                           iterations=nmv, solver=self)

    # -- views / diagnostics ------------------------------------------------

    def _ring_u_standard(self, u):
        """Bucketed ring state -> standard (G, Km, BS, D, ne_pad) numpy."""
        u0 = u[0][0] if self._ring_windowed else u[0]
        out_dt = np.asarray(u0).dtype
        if out_dt.name == "bfloat16":  # bf16 state: host views in f32
            out_dt = np.dtype(np.float32)
        out = np.zeros(
            (self.G, self.Km, self.BS, self.D, self.ne_pad),
            dtype=out_dt,
        )
        for bi, (gs, km_b) in enumerate(self._ring_buckets):
            if self._ring_windowed:
                # paste each segment's hull windows back into the (L, W)
                # rectangle (outside-window slots are exact zeros)
                ub = np.zeros(
                    (len(gs), km_b, self.BS, self.D, self.L, self.W),
                    dtype=out.dtype,
                )
                for si, (l0, l1, o0, dlt, Ws) in enumerate(self._ring_segs):
                    us = np.asarray(u[bi][si])  # (L_s, Gb, Km_b, D, BS, Ws)
                    for li in range(l1 - l0):
                        off = o0 + dlt * li
                        ub[:, :, :, :, l0 + li, off:off + Ws] = (
                            us[li].transpose(0, 1, 3, 2, 4)
                        )
                out[gs, :km_b] = ub.reshape(
                    len(gs), km_b, self.BS, self.D, self.ne_pad
                )
                continue
            if self._ring_wd:
                ub = np.asarray(u[bi])  # (L, Gb, Km_b, BS, W, D)
                if ub.dtype.name == "bfloat16":
                    ub = ub.astype(np.float32)
                ub = ub.transpose(1, 2, 3, 5, 0, 4).reshape(
                    len(gs), km_b, self.BS, self.D, self.ne_pad
                )
            else:
                ub = np.asarray(u[bi])  # (L, Gb, Km_b, D, BS, W)
                ub = ub.transpose(1, 2, 4, 3, 0, 5).reshape(
                    len(gs), km_b, self.BS, self.D, self.ne_pad
                )
            out[gs, :km_b] = ub
        return out

    def u_by_direction(self, u):
        """Map slot-major group-ordered u to direction-major (K, BS, ne, D)."""
        if self.sweep_mode == "ring":
            u = self._ring_u_standard(u)
        else:
            u = np.asarray(u)
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=u.dtype)
        for g in range(self.G):
            valid = self._perm[g] >= 0
            elems = self._perm[g][valid]
            for k in range(self.Km):
                d = self.dirs_pad[g, k]
                if d >= 0:
                    out[d, :, elems, :] = u[g, k][:, :, valid].transpose(2, 0, 1)
        if self.sweep_mode == "ring":
            # ring state is v = M^T u: convert to physical coefficients
            out = np.einsum("eij,kbej->kbei", self._ring_invMT, out)
        out = out[:, : self.BS_orig]  # drop band-shard padding
        if self._super is not None:
            sc = self._super
            blk = out.reshape(self.K, -1, sc.ncell * sc.gsz, sc.D)
            fine = np.zeros(
                (self.K, blk.shape[1], sc.ne_fine, sc.D), blk.dtype
            )
            fine[:, :, sc.scatter_fine()] = blk
            out = fine
        return out

    def heat_flux(self, u):
        """Qc (dim, ne, D) and Qv (dim, ne) from slot-major coefficients."""
        import jax
        import jax.numpy as jnp

        if self.sweep_mode == "ring":
            u = jnp.asarray(self._ring_u_standard(u))
        partial = jnp.einsum("gkbd,gkbip->gdip", self.consts["flux_w"], u)
        pos = self.consts["pos_of_elem"]  # (G, ne)
        gathered = jax.vmap(lambda pg, po: pg[:, :, po])(partial, pos)  # (G,dim,D,ne)
        Qc = jnp.moveaxis(gathered.sum(0), -1, 1)  # (dim, ne, D)
        if self.sweep_mode == "ring":
            # ring state is v = M^T u: convert the flux coefficients
            Qc = jnp.einsum("eij,dej->dei", self.consts["ring_invMT"], Qc)
        if self._super is not None:
            sc = self._super
            scat = self.consts["super_scat"]
            Qcb = Qc.reshape(self.dim, sc.ncell * sc.gsz, sc.D)
            Qv_c = jnp.einsum(
                "degi,egi->deg",
                Qc.reshape(self.dim, sc.ncell, sc.gsz, sc.D),
                self.consts["super_basis"],
            ).reshape(self.dim, -1)
            Qc_f = jnp.zeros(
                (self.dim, sc.ne_fine, sc.D), Qc.dtype
            ).at[:, scat].set(Qcb)
            Qv_f = jnp.zeros(
                (self.dim, sc.ne_fine), Qc.dtype
            ).at[:, scat].set(Qv_c)
            return Qc_f, Qv_f
        Qv = jnp.einsum("dei,ei->de", Qc, self.consts["basis_int_glob"])
        return Qc, Qv


@dataclasses.dataclass
class SolveResult:
    u: object  # (G, Km, BS, D, ne_pad) slot-major, group-level order
    Tc: object  # (ne, D)
    Tv: object  # (ne,)
    residual: float
    iterations: int
    solver: SourceIterationSolver

    def u_dirs(self):
        return self.solver.u_by_direction(self.u)
