"""Slab-lattice domain decomposition: the flagship-capable distributed solver.

JAX analog of DGSolver::PBTE_NonGraySMRT_MPI (ref: reference/DGSolver/
PBTE_NonGraySMRT_MPI.cpp:10-531) for Cartesian lattice meshes, built on the
same shift-structured ring sweep as the single-device fast path:

- the lattice box (n0, n1, n2) is partitioned into contiguous SLABS along a
  major axis a0 (the METIS-partition analog: on a box, slabs are the
  minimal-edge-cut partition);
- each device owns one slab and runs the SAME lattice ring sweep as the
  single-device solver: level l_loc = sum of local transformed coordinates,
  slot w = plane coordinates, upwind neighbors at static shifts into the
  previous level's slab, CLASS-BATCHED transport factors. This removes the
  SpatialShardedSolver's flagship blocker — its per-element A^-1 host
  materialization (G*Km*BS*D^2*ne floats = 38 GB at hex-16^3); here the factors are a few dense D x D inverses per
  direction slot (~10 MB);
- cross-slab coupling is LAGGED one outer iteration (block-Jacobi), exactly
  the reference's halo semantics (ref: PBTE_NonGraySMRT_MPI.cpp:57-181 —
  exchange once per outer iteration): each device extracts its EXIT layer
  (local transformed i'_a0 = n_p - 1) from the previous iterate and
  `lax.ppermute`s it downstream over the "space" axis (one permute per
  sweep sign); the receiver folds it into the solution at its ENTRY rows
  (l_loc == s_w) through the same folded factor the in-sweep coupling uses.
  Devices at the sweep-entry end of the domain have cin = 0 there (true
  boundary), which annihilates the unmatched ppermute garbage;
- direction slots are sharded over the "dir" mesh axis (the OpenMP collapse
  analog), and the residual is psum'd over both axes — fixing the MFEM
  port's rank-local-residual bug (SURVEY.md section 2.4).

Key identity making per-device constants pure SLICES of the global problem:
with transformed slab offsets o'_p (prefix sums of slab thicknesses in sweep
order), partition p's local level l_loc is the global level o'_p + l_loc at
the SAME slot w. The owner mask 0 <= l_loc - s_w < n_p (s_w = plane
coordinate sum of slot w) zeroes non-owned slots; they remain exact-zero
fixed points of the iteration, which is what makes "read zero in-sweep, add
the lagged halo via an entry-row term" exact block-Jacobi.

Dirichlet (type 7) composes like the single-device ring (a static source
slab). Periodic boundaries along the PLANE axes are lagged wrap couplings
implemented as static (level, slot) shifts of the previous iterate; periodic
along the slab axis is excluded by choosing a non-periodic major axis.
Diffuse/specular (legacy types 2/3) are lagged closures over partition-local
face tables: the diffuse hemisphere flux is psum'd over the "dir" axis, the
specular mirror slot is read from an all_gather'd boundary block, and the
B-folded contributions scatter into the solution like the wraps.

Scope: class-uniform lattices (one geometry class after canonical face
ordering — every Cartesian builtin). Graded lattices and unstructured meshes
use SourceIterationSolver / SpatialShardedSolver.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbte.fem import assembly as _assembly
from pbte.models import macroscopic
from pbte.solver.source_iteration import _lattice_ring_tables
from pbte.sweep import planner


class SlabLatticeSolver:
    """Domain-decomposed lattice ring solver over Mesh(("dir", "space"))."""

    def __init__(
        self,
        ops,  # fem.assembly.ElementOps
        quad,
        tables,
        bc_temps: dict,
        device_mesh,  # jax.sharding.Mesh with axes ("dir", "space")
        dtype=None,
        dirichlet_bcs: dict | None = None,
        diffuse_bcs=None,
        specular_bcs=None,
        require_bcs: bool = True,
    ):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as Pspec

        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        np_dtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
        self.mesh = device_mesh
        n_dir = device_mesh.shape["dir"]
        P = device_mesh.shape["space"]
        self.P = P

        self.ne = ne = ops.num_elements
        self.D = D = ops.ndof
        self.nf = nf = ops.faces_per_elem
        self.dim = dim = ops.dim
        self.K = quad.num_directions
        self.BS = BS = tables.num_branches * tables.num_spectral
        self.omega = quad.total_weight
        self._quad = quad
        self._tables = tables

        inv_kn = tables.flat("inv_kn").astype(np.float64)
        vg = tables.flat("vg").astype(np.float64)
        heat_cap = tables.flat("heat_cap").astype(np.float64)
        self.dt_inv = float(inv_kn.max())
        vg_s = vg / self.dt_inv

        # ---- canonical faces + lattice + single-class requirement ----------
        ops_c = _assembly.permute_faces(ops, _assembly.canonical_face_perm(ops))
        if (
            _assembly.element_classes(ops_c).max()
            < _assembly.element_classes(ops).max()
        ):
            ops = ops_c
        cls = _assembly.element_classes(ops)
        if int(cls.max()) != 0:
            raise NotImplementedError(
                f"SlabLatticeSolver needs a class-uniform lattice (got "
                f"{int(cls.max()) + 1} classes); use SourceIterationSolver "
                f"with dir_sharding or SpatialShardedSolver instead"
            )
        sweep_nbr = ops.sweep_neighbor
        lat = planner.detect_lattice(sweep_nbr, ops.normals)
        if lat is None:
            raise NotImplementedError(
                "SlabLatticeSolver requires a Cartesian lattice mesh; use "
                "SpatialShardedSolver for unstructured meshes"
            )
        dims = np.asarray(lat.dims)
        self._ops_basis_int = ops.basis_int.copy()

        # boundary-condition sanity (ref: src/PBTESolver.cpp:286)
        dirichlet_bcs = dirichlet_bcs or {}
        self.has_dirichlet = bool(dirichlet_bcs)
        diffuse_bcs = sorted(int(a) for a in (diffuse_bcs or ()))
        specular_bcs = sorted(int(a) for a in (specular_bcs or ()))
        self._dif_on = bool(diffuse_bcs)
        self._spc_on = bool(specular_bcs)
        bdry = set(int(a) for a in np.unique(ops.face_attr[ops.neighbor < 0]))
        missing = (
            bdry - set(map(int, bc_temps)) - set(map(int, dirichlet_bcs))
            - set(diffuse_bcs) - set(specular_bcs)
        )
        if missing and require_bcs:
            raise ValueError(
                f"boundary attributes without isothermal BC: {sorted(missing)}"
            )
        bc_T = np.zeros((ne, nf))
        for attr, T in bc_temps.items():
            bc_T[ops.face_attr == int(attr)] = float(T)
        dvec = np.zeros((ne, nf, D))
        for attr, gval in dirichlet_bcs.items():
            sel = ops.face_attr == int(attr)
            dvec[sel] = float(gval) * ops.face_int[sel]

        # slab axis: largest non-periodic axis
        per_axis = np.array(
            [bool(ops.periodic[:, lat.face_minus[d]].any()) for d in range(dim)]
        )
        self.has_periodic = bool(ops.periodic.any())
        cand = [d for d in range(dim) if not per_axis[d]]
        if not cand:
            raise NotImplementedError("all axes periodic: no valid slab axis")
        a0 = int(max(cand, key=lambda d: dims[d]))
        self.a0 = a0
        plane = [d for d in range(dim) if d != a0]

        # ---- global sweep plan + lattice slab tables -----------------------
        dirs_np = quad.directions[:, :dim]
        plan = planner.build_plan(sweep_nbr, ops.normals, dirs_np)
        self.plan = plan
        G = plan.num_groups
        lt = _lattice_ring_tables(lat, plan, dirs_np, major_axis=a0)
        if lt is None:
            raise NotImplementedError("lattice slab tables unavailable")
        tabs, axis_faces, shifts = lt  # (G, L, W), (G, dim), (dim,)
        Lg, W = tabs.shape[1], tabs.shape[2]
        self.W = W
        self.shift_vals = tuple(int(s) for s in shifts)
        n0 = int(dims[a0])
        if dim == 3:
            n1, n2 = int(dims[plane[0]]), int(dims[plane[1]])
            s_w = np.arange(W) // n2 + np.arange(W) % n2
        else:
            n1, n2 = int(dims[plane[0]]), 1
            s_w = np.arange(W)
        self._s_w = s_w.astype(np.int32)

        Km = max(len(d) for d in plan.dirs_of_group)
        Km = -(-Km // n_dir) * n_dir
        self.G, self.Km = G, Km
        dirs_pad = np.full((G, Km), -1, dtype=np.int64)
        for g, d in enumerate(plan.dirs_of_group):
            dirs_pad[g, : len(d)] = d
        self.dirs_pad = dirs_pad
        dir_valid = dirs_pad >= 0
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        sgn_a0 = np.array(
            [1 if dirs_np[plan.dirs_of_group[g][0]][a0] > 0 else -1
             for g in range(G)]
        )
        self._g_plus = np.flatnonzero(sgn_a0 > 0)
        self._g_minus = np.flatnonzero(sgn_a0 < 0)

        # ---- class-batched folded transport factors ------------------------
        # B = M^T A^-1 (the ring state is v = M^T u);
        # BCv_f = vg_b * B * (C_f M^-T) — see solver/source_iteration.py
        rep = int(np.flatnonzero(cls == 0)[0])
        mass_r = ops.mass[rep]
        massT_r = mass_r.T
        invMT = np.linalg.inv(massT_r)
        self._invMT = invMT  # (D, D), uniform
        dk_all = dirs_np[dirs_safe]  # (G, Km, dim)
        fd = np.einsum("fd,gkd->gkf", ops.normals[rep], dk_all)
        G_k = -np.einsum("gkd,dij->gkij", dk_all, ops.stiff[rep]) + np.einsum(
            "gkf,fij->gkij", np.maximum(fd, 0.0), ops.face_mass[rep]
        )
        A = (
            mass_r[None, None, None]
            + vg_s[None, None, :, None, None] * G_k[:, :, None]
        )  # (G, Km, BS, D, D)
        b_cls = np.einsum("ij,gkbjl->gkbil", massT_r, np.linalg.inv(A))
        ccpl = _assembly.class_coupling(ops, cls)
        if ccpl is None:
            raise NotImplementedError(
                "per-element couplings on a single-class lattice (unexpected)"
            )
        ccplf = np.einsum("fij,jk->fik", ccpl[0], invMT)  # (nf, D, D)
        ccpl_ax = ccplf[axis_faces]  # (G, dim, D, D) axis-ordered inflow
        bcv = np.einsum(
            "gkbij,gfjl,b->gfkbil", b_cls, ccpl_ax, vg_s
        )  # (G, dim, Km, BS, D, D)
        # uniform inflow coefficient per (group, axis, slot)
        cin_gjk = np.minimum(
            np.einsum("gjd,gkd->gjk", ops.normals[rep][axis_faces], dk_all),
            0.0,
        )  # (G, dim, Km)

        # ---- slab partition along a0 ---------------------------------------
        base, rem = divmod(n0, P)
        n_p = np.array([base + (p < rem) for p in range(P)])
        if (n_p <= 0).any():
            raise ValueError(f"{P} slabs over n0={n0}: empty partition")
        o_p = np.concatenate([[0], np.cumsum(n_p)[:-1]])
        self.n_p, self.o_p = n_p, o_p
        Lrest = Lg - n0
        L_max = int(n_p.max()) + Lrest
        self.L = L_max
        to_plus = o_p
        to_minus = n0 - o_p - n_p

        owner_of_coord = np.zeros(n0, dtype=np.int64)
        for p in range(P):
            owner_of_coord[o_p[p] : o_p[p] + n_p[p]] = p
        owner = owner_of_coord[lat.coords[:, a0]]
        ne_loc = int(np.bincount(owner, minlength=P).max())
        self.ne_loc = ne_loc
        elems_p = np.full((P, ne_loc), -1, dtype=np.int64)
        loc_of_global = np.full(ne, -1, dtype=np.int64)
        for p in range(P):
            es = np.flatnonzero(owner == p)
            elems_p[p, : len(es)] = es
            loc_of_global[es] = np.arange(len(es))
        self.elems_p = elems_p

        # ---- per-(p, g) local slab tables ----------------------------------
        perm = tabs.reshape(G, Lg * W).astype(np.int64)
        pos_valid_g = perm >= 0
        perm_safe = np.where(pos_valid_g, perm, 0)
        # global boundary source slabs (per group): sum over faces of
        # cin_bnd * bc_T * int_F phi (ref: src/PBTESolver.cpp:261-300)
        fdot_full = np.einsum("fd,gkd->gkf", ops.normals[rep], dk_all)
        cin_full = np.minimum(fdot_full, 0.0)  # (G, Km, nf)
        is_bnd = (ops.neighbor[perm_safe] < 0) & pos_valid_g[:, :, None]
        bsrc_glob = np.einsum(
            "gkf,gpf,gpf,gpfi->gkip",
            cin_full, is_bnd, bc_T[perm_safe], ops.face_int[perm_safe],
        ).reshape(G, Km, D, Lg, W)
        dsrc_glob = None
        if self.has_dirichlet:
            dsrc_glob = np.einsum(
                "gkf,gpf,gpfi->gkip", cin_full, is_bnd, dvec[perm_safe]
            ).reshape(G, Km, D, Lg, W)

        lrow = np.arange(L_max)[:, None]
        # owner mask per partition: 0 <= l_loc - s_w < n_p  (L_max, W)
        own = np.stack(
            [
                (lrow - s_w[None, :] >= 0) & (lrow - s_w[None, :] < n_p[p])
                for p in range(P)
            ]
        )  # (P, L_max, W)
        # in-sweep interior mask per (partition, level, axis, slot):
        # upwind neighbor along axis j exists inside the partition and is
        # not a periodic wrap.  i'_a0 = l - s_w (local), i'_p1 = w // n2,
        # i'_p2 = w % n2 — all group-independent in transformed coordinates.
        ip_ax = np.zeros((L_max, dim, W), dtype=np.int64)
        ip_ax[:, a0] = lrow - s_w[None, :]
        if dim == 3:
            ip_ax[:, plane[0]] = (np.arange(W) // n2)[None, :]
            ip_ax[:, plane[1]] = (np.arange(W) % n2)[None, :]
        else:
            ip_ax[:, plane[0]] = np.arange(W)[None, :]
        cin_mask = np.stack(
            [(ip_ax > 0) & own[p][:, None, :] for p in range(P)]
        ).astype(np_dtype)  # (P, L_max, dim, W)

        tabs_loc = np.full((P, G, L_max, W), -1, dtype=np.int64)
        bsrc_loc = np.zeros((P, L_max, G, Km, D, W), dtype=np_dtype)
        dsrc_loc = (
            np.zeros((P, L_max, G, Km, D, W), dtype=np_dtype)
            if self.has_dirichlet else None
        )
        for p in range(P):
            lp = int(n_p[p]) + Lrest
            for g in range(G):
                to = int(to_plus[p] if sgn_a0[g] > 0 else to_minus[p])
                tl = tabs[g, to : to + lp]
                tabs_loc[p, g, :lp] = np.where(own[p, :lp], tl, -1)
                bsrc_loc[p, :lp, g] = (
                    np.moveaxis(bsrc_glob[g, :, :, to : to + lp], 2, 0)
                    * own[p, :lp, None, None, :]
                )
                if dsrc_glob is not None:
                    dsrc_loc[p, :lp, g] = (
                        np.moveaxis(dsrc_glob[g, :, :, to : to + lp], 2, 0)
                        * own[p, :lp, None, None, :]
                    )
        self._tabs_loc = tabs_loc

        perm_loc = np.zeros((P, G, L_max * W), dtype=np.int64)
        valid_loc = (tabs_loc.reshape(P, G, -1) >= 0)
        pos_loc = np.zeros((P, G, ne_loc), dtype=np.int64)
        for p in range(P):
            for g in range(G):
                t = tabs_loc[p, g].reshape(-1)
                v = t >= 0
                perm_loc[p, g][v] = loc_of_global[t[v]]
                pos_loc[p, g][loc_of_global[t[v]]] = np.flatnonzero(v)

        ev = elems_p >= 0
        es_safe = np.where(ev, elems_p, 0)
        basis_loc = ops.basis_int[es_safe] * ev[..., None]

        # halo tables: exit gather level and entry inflow coefficient mask
        exit_lev = (n_p[:, None] - 1 + s_w[None, :]).astype(np.int32)
        # entry faces are interior iff an upstream slab exists in this
        # group's sweep order (per-(p, g) scalar)
        has_up = np.zeros((P, G), dtype=np_dtype)
        for p in range(P):
            for g in range(G):
                to = int(to_plus[p] if sgn_a0[g] > 0 else to_minus[p])
                has_up[p, g] = 1.0 if to > 0 else 0.0

        # periodic wrap couplings (plane axes only): static (level, slot)
        # shifts of the previous iterate with per-axis receive masks
        self._wrap_axes = []
        if self.has_periodic:
            if per_axis[a0]:
                raise NotImplementedError(
                    "periodic along the slab axis is unsupported"
                )
            for j in range(dim):
                if not per_axis[j]:
                    continue
                nj = int(dims[j])
                if j == (plane[0] if dim >= 2 else -1):
                    wshift = (nj - 1) * n2 if dim == 3 else (nj - 1)
                    wmask = (
                        (np.arange(W) // n2 == 0) if dim == 3
                        else (np.arange(W) == 0)
                    )
                else:  # plane[1] (3D only)
                    wshift = nj - 1
                    wmask = np.arange(W) % n2 == 0
                self._wrap_axes.append(
                    (j, nj - 1, int(wshift), wmask.astype(np_dtype))
                )

        # ---- lagged reflective BCs (legacy types 2/3) ------------------------
        # Partition-local padded face tables, same closures as the ring path
        # (solver/source_iteration.py): per outer iteration the previous
        # iterate is read at each reflective face's (level, slot), the
        # diffuse hemisphere flux is psum'd over the "dir" mesh axis (every
        # dir shard holds part of the outgoing hemisphere), the specular
        # mirror slot is fetched from an all_gather'd boundary block, and
        # the B-folded contribution is scattered into the solution like the
        # periodic wraps. Faces are owned by exactly one slab, so no space-
        # axis collective is needed.
        w_glob = quad.weights

        def _part_face_tables(attrs):
            rows = np.argwhere(
                np.isin(ops.face_attr, attrs)
                & (ops.neighbor < 0) & ops.face_valid
            )
            if len(rows) == 0:
                # no boundary face carries the attr: the closure is inert
                # (mirrors SourceIterationSolver, which disables it)
                return None
            e_a, f_a = rows[:, 0], rows[:, 1]
            own_f = owner[e_a]
            Pf = max(int(np.bincount(own_f, minlength=P).max()), 1)
            # padded per-partition face index into rows (or -1)
            idx = np.full((P, Pf), -1, dtype=np.int64)
            for p in range(P):
                sel = np.flatnonzero(own_f == p)
                idx[p, : len(sel)] = sel
            vld = idx >= 0
            safe = np.where(vld, idx, 0)
            e_p, f_p = e_a[safe], f_a[safe]  # (P, Pf)
            n_p_f = ops.normals[e_p, f_p]  # (P, Pf, dim)
            sdotn = np.einsum(
                "gkd,pqd->pgkq", dk_all, n_p_f
            ) * (dir_valid[None, :, :, None] & vld[:, None, None, :])
            le = loc_of_global[e_p]  # (P, Pf) local element
            pos = np.take_along_axis(
                pos_loc, np.clip(le, 0, None)[:, None, :], axis=2
            )  # (P, G, Pf) local slab flat position
            pl, pw = pos // W, pos % W
            return e_p, f_p, vld, sdotn, pl, pw

        self._refl_tabs = None
        rt = {}
        if self._dif_on:
            tbl = _part_face_tables(diffuse_bcs)
            if tbl is None:
                self._dif_on = False
        if self._dif_on:
            e_p, f_p, vld, sdotn, pl, pw = tbl
            fint_p = ops.face_int[e_p, f_p] * vld[..., None]  # (P, Pf, D)
            cn = (
                w_glob[:, None, None] * np.maximum(
                    -np.einsum("kd,pqd->kpq", dirs_np,
                               ops.normals[e_p, f_p]), 0.0
                )
            ).sum(axis=0)  # (P, Pf) incoming-hemisphere weight
            areaF = fint_p.sum(axis=-1)
            rt["dif"] = dict(
                pl=pl, pw=pw,
                fint=fint_p.astype(np_dtype),
                fvec=np.einsum("pqi,ij->pqj", fint_p, invMT).astype(np_dtype),
                cin=np.minimum(sdotn, 0.0).astype(np_dtype),  # (P,G,Km,Pf)
                wplus=(
                    w_glob[dirs_safe][None, :, :, None]
                    * np.maximum(sdotn, 0.0)
                ).astype(np_dtype),
                norm=(1.0 / np.maximum(cn * areaF, 1e-300)
                      * vld).astype(np_dtype),
            )
        if self._spc_on:
            tbl = _part_face_tables(specular_bcs)
            if tbl is None:
                self._spc_on = False
        if self._spc_on:
            from pbte.validation.oracle import mirror_direction_map

            e_p, f_p, vld, sdotn, pl, pw = tbl
            n_s = ops.normals[e_p, f_p]
            ax_ok = np.abs(np.abs(n_s).max(axis=-1) - 1.0) < 1e-9
            if not bool((ax_ok | ~vld).all()):
                raise ValueError("specular faces must be axis-aligned")
            ax_p = np.argmax(np.abs(n_s), axis=-1)  # (P, Pf)
            mirror = mirror_direction_map(
                quad, dim, axes=set(int(a) for a in np.unique(ax_p[vld]))
            )  # (dim, K)
            g_of_dir, k_of_dir = planner.dir_slot_maps(dirs_pad)
            km_glob = mirror[
                ax_p[:, None, None, :], dirs_safe[None, :, :, None]
            ]  # (P, G, Km, Pf)
            km_glob = np.where(
                dir_valid[None, :, :, None] & vld[:, None, None, :],
                km_glob, 0,
            )
            fm_p = (
                ops.face_mass[e_p, f_p] * vld[..., None, None]
            )  # (P, Pf, D, D)
            rt["spc"] = dict(
                pl=pl, pw=pw,
                fmv=np.einsum("pqil,lj->pqij", fm_p, invMT).astype(np_dtype),
                cin=np.minimum(sdotn, 0.0).astype(np_dtype),
                gk=(
                    g_of_dir[km_glob] * Km + k_of_dir[km_glob]
                ).astype(np.int32),  # (P, G, Km, Pf) flat global (g*, k*)
            )
        if rt:
            self._refl_tabs = rt

        # ---- device placement ----------------------------------------------
        S, DIR = "space", "dir"

        def puts(a, axes, dt=np_dtype):
            return jax.device_put(
                np.ascontiguousarray(a, dtype=dt),
                NamedSharding(self.mesh, Pspec(*axes)),
            )

        mw = macroscopic.macro_weights(quad, tables)
        mw_slots = np.where(dir_valid[..., None], mw[dirs_safe], 0.0)

        self.consts = dict(
            bsrc=puts(bsrc_loc, (S, None, None, DIR)),
            b_cls=puts(b_cls, (None, DIR)),  # (G, Km, BS, D, D)
            bcv=puts(bcv, (None, None, DIR)),  # (G, dim, Km, BS, D, D)
            cin_gjk=puts(cin_gjk, (None, None, DIR)),  # (G, dim, Km)
            cin_mask=puts(cin_mask, (S,)),  # (P, L_max, dim, W)
            own=puts(own.astype(np_dtype), (S,)),  # (P, L_max, W)
            massT=puts(massT_r, ()),  # (D, D)
            invMT=puts(invMT, ()),  # (D, D)
            perm_loc=puts(perm_loc, (S,), np.int32),
            valid=puts(
                valid_loc.reshape(P, G, L_max, W).astype(np_dtype), (S,)
            ),  # (P, G, L_max, W)
            pos_loc=puts(pos_loc, (S,), np.int32),
            basis_int=puts(basis_loc, (S,)),
            elem_valid=puts(ev, (S,), np.bool_),
            macro_w=puts(mw_slots, (None, DIR)),  # (G, Km, BS)
            vg=puts(vg_s, ()),
            src_w=puts(inv_kn * heat_cap / (self.omega * self.dt_inv), ()),
            relax_w=puts(1.0 - inv_kn / self.dt_inv, ()),
            bc_w=puts(heat_cap / self.omega, ()),
            exit_lev=puts(exit_lev, (S,), np.int32),  # (P, W)
            has_up=puts(has_up, (S,)),  # (P, G)
            **(
                {"dsrc": puts(dsrc_loc, (S, None, None, DIR))}
                if self.has_dirichlet else {}
            ),
            **(
                {
                    "rdif_pl": puts(rt["dif"]["pl"], (S,), np.int32),
                    "rdif_pw": puts(rt["dif"]["pw"], (S,), np.int32),
                    "rdif_fint": puts(rt["dif"]["fint"], (S,)),
                    "rdif_fvec": puts(rt["dif"]["fvec"], (S,)),
                    "rdif_cin": puts(rt["dif"]["cin"], (S, None, DIR)),
                    "rdif_wplus": puts(rt["dif"]["wplus"], (S, None, DIR)),
                    "rdif_norm": puts(rt["dif"]["norm"], (S,)),
                }
                if self._dif_on else {}
            ),
            **(
                {
                    "rspc_pl": puts(rt["spc"]["pl"], (S,), np.int32),
                    "rspc_pw": puts(rt["spc"]["pw"], (S,), np.int32),
                    "rspc_fmv": puts(rt["spc"]["fmv"], (S,)),
                    "rspc_cin": puts(rt["spc"]["cin"], (S, None, DIR)),
                    "rspc_gk": puts(rt["spc"]["gk"], (S, None, DIR), np.int32),
                }
                if self._spc_on else {}
            ),
        )
        self._step = jax.jit(self._step_impl, donate_argnums=(1,))
        # the Krylov-accelerated solve re-reads x after F(x): no donation
        self._step_plain = jax.jit(self._step_impl)

    # ------------------------------------------------------------------

    def initial_state(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as Pspec

        u = jax.device_put(
            jnp.zeros(
                (self.P, self.L, self.G, self.Km, self.D, self.BS, self.W),
                dtype=self.dtype,
            ),
            NamedSharding(self.mesh, Pspec("space", None, None, "dir")),
        )
        Tc = jax.device_put(
            jnp.zeros((self.P, self.ne_loc, self.D), dtype=self.dtype),
            NamedSharding(self.mesh, Pspec("space")),
        )
        Tv = jax.device_put(
            jnp.zeros((self.P, self.ne_loc), dtype=self.dtype),
            NamedSharding(self.mesh, Pspec("space")),
        )
        return u, Tc, Tv

    def _step_impl(self, c, u, Tc, Tv_prev):
        import jax
        import jax.numpy as jnp
        from jax import lax
        try:
            from jax import shard_map
        except ImportError:  # pragma: no cover
            from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as Pspec

        S, DIR = "space", "dir"
        G, D, BS, W, L = self.G, self.D, self.BS, self.W, self.L
        shift_vals = self.shift_vals
        Pn = self.P
        g_plus, g_minus = self._g_plus, self._g_minus
        s_w = jnp.asarray(self._s_w)

        in_specs = (
            dict(
                bsrc=Pspec(S, None, None, DIR),
                b_cls=Pspec(None, DIR),
                bcv=Pspec(None, None, DIR),
                cin_gjk=Pspec(None, None, DIR),
                cin_mask=Pspec(S),
                own=Pspec(S),
                massT=Pspec(),
                invMT=Pspec(),
                perm_loc=Pspec(S),
                valid=Pspec(S),
                pos_loc=Pspec(S),
                basis_int=Pspec(S),
                elem_valid=Pspec(S),
                macro_w=Pspec(None, DIR),
                vg=Pspec(),
                src_w=Pspec(),
                relax_w=Pspec(),
                bc_w=Pspec(),
                exit_lev=Pspec(S),
                has_up=Pspec(S),
                **({"dsrc": Pspec(S, None, None, DIR)}
                   if self.has_dirichlet else {}),
                **(
                    {
                        "rdif_pl": Pspec(S), "rdif_pw": Pspec(S),
                        "rdif_fint": Pspec(S), "rdif_fvec": Pspec(S),
                        "rdif_cin": Pspec(S, None, DIR),
                        "rdif_wplus": Pspec(S, None, DIR),
                        "rdif_norm": Pspec(S),
                    }
                    if self._dif_on else {}
                ),
                **(
                    {
                        "rspc_pl": Pspec(S), "rspc_pw": Pspec(S),
                        "rspc_fmv": Pspec(S),
                        "rspc_cin": Pspec(S, None, DIR),
                        "rspc_gk": Pspec(S, None, DIR),
                    }
                    if self._spc_on else {}
                ),
            ),
            Pspec(S, None, None, DIR),  # u
            Pspec(S),  # Tc
            Pspec(S),  # Tv
        )
        out_specs = (Pspec(S, None, None, DIR), Pspec(S), Pspec(S), Pspec())

        def device_step(cl, u_l, Tc_l, Tv_prev_l):
            u_l = u_l[0]  # (L, G, Kl, D, BS, W)
            Tc_l = Tc_l[0]
            Tv_prev_l = Tv_prev_l[0]
            vg = cl["vg"]
            src_w, relax_w, bc_w = cl["src_w"], cl["relax_w"], cl["bc_w"]
            exit_lev = cl["exit_lev"][0]  # (W,)
            valid = cl["valid"][0]  # (G, L, W)
            cin_mask = cl["cin_mask"][0]  # (L, dim, W)
            own = cl["own"][0]  # (L, W)
            Kl = u_l.shape[2]

            # ---- lagged halo: exit layer -> downstream slab ----------------
            ex = jnp.take_along_axis(
                u_l, exit_lev[None, None, None, None, None, :], axis=0
            )[0]  # (G, Kl, D, BS, W)
            halo = jnp.zeros_like(ex)
            for gs, sh in ((g_plus, 1), (g_minus, -1)):
                if len(gs) == 0:
                    continue
                perm = [
                    (i, i + sh) for i in range(Pn) if 0 <= i + sh < Pn
                ]
                recv = lax.ppermute(ex[gs], S, perm=perm)
                halo = halo.at[gs].set(recv)
            # entry contribution in solution space (B and vg pre-folded):
            # hsol = BCv_a0 @ (cin_a0 * has_upstream * v_halo)
            cin_a0 = (
                cl["cin_gjk"][:, self.a0, :Kl] * cl["has_up"][0][:, None]
            )  # (G, Kl)
            hin = halo * cin_a0[:, :, None, None, None]
            hsol = jnp.einsum(
                "gkbij,gkjbw->gkibw", cl["bcv"][:, self.a0, :Kl], hin
            )  # (G, Kl, D, BS, W)

            # ---- lagged plane-axis periodic wrap ---------------------------
            # contribution at (l, w in wrap set): from prev iterate at
            # (l + lshift, w + wshift); folded through the same BCv factor
            wrap_sol = None
            for (j, lshift, wshift, wmask) in self._wrap_axes:
                src = jnp.zeros_like(u_l)
                src = src.at[: L - lshift, ..., : W - wshift].set(
                    u_l[lshift:, ..., wshift:]
                )
                wm = jnp.asarray(wmask, u_l.dtype) * own  # (L?, W)*(L, W)
                wsrc = (
                    src
                    * cl["cin_gjk"][None, :, j, :Kl, None, None, None]
                    * wm[:, None, None, None, None, :]
                )
                ws = jnp.einsum(
                    "gkbij,lgkjbw->lgkibw", cl["bcv"][:, j, :Kl], wsrc
                )
                wrap_sol = ws if wrap_sol is None else wrap_sol + ws

            # ---- lagged reflective closures (legacy types 2/3) -------------
            # Same math as the single-device ring (source_iteration.py): the
            # previous iterate is read at each reflective face's local slab
            # (level, slot); the diffuse hemisphere flux sums outgoing
            # directions across dir shards (psum), the specular mirror slot
            # comes from an all_gather'd boundary block; the contribution is
            # folded through B here (this body subtracts lagged terms in
            # SOLUTION space) and scattered like the periodic wraps.
            if self._refl_tabs is not None:
                gi = jnp.arange(G)[:, None]
                rsol = jnp.zeros_like(u_l)
                bcls_l = cl["b_cls"][:, :Kl]  # (G, Kl, BS, D, D)
                if self._dif_on:
                    pl, pw = cl["rdif_pl"][0], cl["rdif_pw"][0]  # (G, Pf)
                    vb = u_l[pl, gi, :, :, :, pw]  # (G, Pf, Kl, D, BS)
                    flux = lax.psum(jnp.einsum(
                        "gkq,qj,gqkjb->bq",
                        cl["rdif_wplus"][0][:, :Kl], cl["rdif_fvec"][0], vb,
                    ), DIR)
                    u_in = flux * cl["rdif_norm"][0][None]  # (BS, Pf)
                    dif_rhs = -jnp.einsum(
                        "gkq,b,bq,qi->gqkib",
                        cl["rdif_cin"][0][:, :Kl], vg, u_in,
                        cl["rdif_fint"][0],
                    )
                    rsol = rsol.at[pl, gi, :, :, :, pw].add(
                        -jnp.einsum("gkbij,gqkjb->gqkib", bcls_l, dif_rhs)
                    )
                if self._spc_on:
                    pl, pw = cl["rspc_pl"][0], cl["rspc_pw"][0]
                    vb = u_l[pl, gi, :, :, :, pw]  # (G, Pf, Kl, D, BS)
                    vb_all = lax.all_gather(
                        vb, DIR, axis=2, tiled=True
                    )  # (G, Pf, Km, D, BS)
                    vfl = jnp.moveaxis(vb_all, 1, 2).reshape(
                        (G * self.Km,) + vb_all.shape[1:2] + vb_all.shape[3:]
                    )  # (G*Km, Pf, D, BS)
                    p_idx = jnp.arange(vb.shape[1])[None, None, :]
                    v_m = vfl[
                        cl["rspc_gk"][0][:, :Kl], p_idx
                    ]  # (G, Kl, Pf, D, BS)
                    spc_rhs = -jnp.einsum(
                        "gkq,b,qij,gkqjb->gqkib",
                        cl["rspc_cin"][0][:, :Kl], vg,
                        cl["rspc_fmv"][0], v_m,
                    )
                    rsol = rsol.at[pl, gi, :, :, :, pw].add(
                        -jnp.einsum("gkbij,gqkjb->gqkib", bcls_l, spc_rhs)
                    )
                wrap_sol = rsol if wrap_sol is None else wrap_sol + rsol

            # ---- lagged temperature slab (masked to owned slots) -----------
            TcT = Tc_l.T  # (D, ne_loc)
            tc_slab = jnp.transpose(
                TcT[:, cl["perm_loc"][0]].reshape(D, G, L, W), (2, 1, 0, 3)
            ) * jnp.moveaxis(valid, 0, 1)[:, :, None, :]  # (L, G, D, W)
            ttc = jnp.einsum("ij,lgjw->lgiw", cl["massT"], tc_slab)

            l_idx = jnp.arange(L, dtype=jnp.int32)

            def ring_group(v_g, ttc_g, bsrc_g, cing, bcls_g, bcv_g, hsol_g,
                           mw_g, *extra):
                # v_g (L, Kl, D, BS, W)
                ei = 0
                if self.has_dirichlet:
                    dsrc_g = extra[ei]; ei += 1
                else:
                    dsrc_g = jnp.zeros((L, 1, 1, 1), v_g.dtype)
                if wrap_sol is not None:
                    wsol_g = extra[ei]; ei += 1
                else:
                    wsol_g = jnp.zeros((L, 1, 1, 1, 1), v_g.dtype)
                # per-level inflow coefficients: uniform value x mask
                # cing (dim, Kl); cin_mask (L, dim, W)

                def body(ring, xs):
                    v_l, ttc_l, bsrc_l, m_l_mask, li, ds_l, ws_l = xs
                    rhs = (
                        src_w[None, None, :, None] * ttc_l[None, :, None]
                        + relax_w[None, None, :, None] * v_l
                        - (vg * bc_w)[None, None, :, None]
                        * bsrc_l[:, :, None]
                    )
                    if self.has_dirichlet:
                        rhs = rhs - vg[None, None, :, None] * ds_l[:, :, None]
                    sol = jnp.einsum("kbij,kjbw->kibw", bcls_g, rhs)
                    for fi, s in enumerate(shift_vals):
                        yf = ring
                        if s:
                            yf = jnp.pad(
                                yf[..., :-s],
                                ((0, 0), (0, 0), (0, 0), (s, 0)),
                            )
                        cin_l = (
                            cing[fi][:, None, None, None]
                            * m_l_mask[fi][None, None, None, :]
                        )
                        sol = sol - jnp.einsum(
                            "kbij,kjbw->kibw", bcv_g[fi], yf * cin_l
                        )
                    # lagged halo at entry rows (l_loc == s_w)
                    emask = (li == s_w).astype(sol.dtype)
                    sol = sol - hsol_g * emask[None, None, None, :]
                    if wrap_sol is not None:
                        sol = sol - ws_l
                    m_l = jnp.einsum("kb,kibw->iw", mw_g, sol)
                    return sol, (sol, m_l)

                ring0 = jnp.zeros((v_g.shape[1], D, BS, W), v_g.dtype)
                xs = (v_g, ttc_g, bsrc_g, cin_mask, l_idx, dsrc_g, wsol_g)
                _, (ys, ms) = lax.scan(body, ring0, xs)
                return ys, ms

            extras = []
            extra_axes = []
            if self.has_dirichlet:
                extras.append(cl["dsrc"][0])
                extra_axes.append(1)
            if wrap_sol is not None:
                extras.append(wrap_sol)
                extra_axes.append(1)
            ys, ms = jax.vmap(
                ring_group,
                in_axes=(1, 1, 1, 0, 0, 0, 0, 0) + tuple(extra_axes),
                out_axes=(1, 0),
            )(
                u_l, ttc, cl["bsrc"][0], cl["cin_gjk"][:, :, :Kl],
                cl["b_cls"][:, :Kl], cl["bcv"][:, :, :Kl], hsol,
                cl["macro_w"][:, :Kl], *extras,
            )
            # ys (L, G, Kl, D, BS, W); ms (G, L, D, W)
            partial = jnp.transpose(ms, (0, 2, 1, 3)).reshape(G, D, L * W)
            pos = cl["pos_loc"][0]  # (G, ne_loc)
            Tc_v = jax.vmap(lambda pg, po: pg[:, po])(partial, pos).sum(0).T
            Tc_v = lax.psum(Tc_v, DIR)  # (ne_loc, D)
            Tc_new = Tc_v @ jnp.swapaxes(cl["invMT"], 0, 1)
            Tv_new = jnp.einsum(
                "ei,ei->e", Tc_new, cl["basis_int"][0]
            ) * cl["elem_valid"][0]
            scale = jnp.maximum(
                lax.pmax(lax.pmax(jnp.max(jnp.abs(Tv_new)), S), DIR),
                jnp.finfo(Tv_new.dtype).tiny,
            )
            a = Tv_new / scale
            b = Tv_prev_l / scale
            num = lax.psum(jnp.sum((a - b) ** 2), S)
            den = lax.psum(jnp.sum(a ** 2), S)
            res = jnp.sqrt(num) / jnp.sqrt(den)
            return ys[None], Tc_new[None], Tv_new[None], res

        return shard_map(
            device_step, mesh=self.mesh, in_specs=in_specs,
            out_specs=out_specs, check_vma=False,
        )(c, u, Tc, Tv_prev)

    # ------------------------------------------------------------------

    def step(self, u, Tc, Tv_prev):
        return self._step(self.consts, u, Tc, Tv_prev)

    def solve(self, tol=1e-7, max_iter=101, state=None, verbose=True,
              check_every=1, sync_every=10, callback=None,
              checkpoint_path=None, checkpoint_every=25, accelerate=None,
              cycle_hook=None, cycle_every=0):
        import jax

        if cycle_hook and cycle_every > 0 and accelerate == "bicgstab":
            raise ValueError("cycle_hook is a plain-iteration cadence; the "
                             "Krylov outer loop has no outer iterates to "
                             "export (use accelerate='none' with --vtu-every)")
        if accelerate not in (None, "none", "bicgstab"):
            raise ValueError(f"unknown accelerate={accelerate!r}")
        if accelerate == "bicgstab":
            # the slab step is affine in (u, Tc) — the lagged ppermute halo
            # is linear in the previous iterate — so the shared Krylov outer
            # loop applies unchanged (see solver/accel.py)
            from pbte.solver import accel

            def step_fn(u, Tc, Tv_prev):
                return self._step_plain(self.consts, u, Tc, Tv_prev)

            save_ckpt = None
            if checkpoint_path:
                import jax.numpy as jnp
                from jax.sharding import NamedSharding, PartitionSpec as Ps

                from pbte.io.checkpoint import accel_ckpt_saver

                save_ckpt = accel_ckpt_saver(
                    checkpoint_path, self,
                    jax.device_put(
                        jnp.zeros((self.P, self.ne_loc), dtype=self.dtype),
                        NamedSharding(self.mesh, Ps("space")),
                    ),
                )

            u_f, Tc_f, Tv_f, tv_res, nmv = accel.bicgstab_outer(
                step_fn, self.initial_state(), state, tol, max_iter,
                verbose=verbose, callback=callback,
                check_every=check_every, label="pbte:slab",
                save_ckpt=save_ckpt, ckpt_every=checkpoint_every,
            )
            return SlabSolveResult(u=u_f, Tc=Tc_f, Tv=Tv_f,
                                   residual=tv_res, iterations=nmv,
                                   solver=self)
        u, Tc, Tv = state if state is not None else self.initial_state()
        prev_Tv = Tv
        res = float("inf")
        it = 0
        for it in range(1, max_iter + 1):
            u, Tc_new, Tv_new, res_dev = self.step(u, Tc, prev_Tv)
            if sync_every and it % sync_every == 0:
                jax.block_until_ready(res_dev)
            if it % check_every == 0 or it == max_iter:
                res = float(res_dev)
                if verbose:
                    print(f"[pbte:slab] iter {it}, residual = {res:.6e}")
                if callback is not None:
                    callback(it, res)
                if res < tol:
                    Tc, prev_Tv = Tc_new, Tv_new
                    break
            prev_Tv = Tv_new
            Tc = Tc_new
            if cycle_hook and cycle_every > 0 and it % cycle_every == 0:
                cycle_hook(it, u, Tc, prev_Tv)
            if checkpoint_path and it % checkpoint_every == 0:
                from pbte.io.checkpoint import save_checkpoint

                save_checkpoint(checkpoint_path, self, u, Tc, prev_Tv, it,
                                float(res_dev))
        return SlabSolveResult(
            u=u, Tc=Tc, Tv=prev_Tv, residual=res, iterations=it, solver=self
        )

    def gather_Tc(self, Tc) -> np.ndarray:
        Tc = np.asarray(Tc)
        out = np.zeros((self.ne, self.D), dtype=Tc.dtype)
        for p in range(self.P):
            es = self.elems_p[p]
            m = es >= 0
            out[es[m]] = Tc[p, m]
        return out

    @property
    def element_partition(self) -> np.ndarray:
        """(ne,) owning slab per element (for partitioned ParaView output)."""
        part = np.full(self.ne, -1, dtype=np.int32)
        for p in range(self.P):
            es = self.elems_p[p]
            part[es[es >= 0]] = p
        return part

    def u_by_direction(self, u) -> np.ndarray:
        """(P, L, G, Km, D, BS, W) state -> (K, BS, ne, D) global physical
        coefficients (the ring state is v = M^T u)."""
        u = np.asarray(u)
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=u.dtype)
        for p in range(self.P):
            for g in range(self.G):
                tab = self._tabs_loc[p, g]  # (L, W)
                ls, ws = np.nonzero(tab >= 0)
                elems = tab[ls, ws]
                for k in range(self.Km):
                    d = self.dirs_pad[g, k]
                    if d < 0:
                        continue
                    vals = u[p, ls, g, k, :, :, ws]  # (n, D, BS)
                    out[d, :, elems, :] = np.swapaxes(vals, 1, 2)
        return np.einsum("ij,kbej->kbei", self._invMT, out)

    def heat_flux(self, u):
        ud = self.u_by_direction(u)
        fw = macroscopic.flux_weights(self._quad, self._tables, self.dim)
        Qc = np.einsum("dkb,kbei->dei", fw, ud)
        Qv = np.einsum("dei,ei->de", Qc, self._ops_basis_int)
        return Qc, Qv


@dataclasses.dataclass
class SlabSolveResult:
    u: object
    Tc: object
    Tv: object
    residual: float
    iterations: int
    solver: SlabLatticeSolver

    def Tc_global(self) -> np.ndarray:
        return self.solver.gather_Tc(self.Tc)

    def u_dirs(self) -> np.ndarray:
        return self.solver.u_by_direction(self.u)
