"""Spatially-sharded solver: domain decomposition over a 2-D device mesh.

JAX equivalent of the reference's flagship distributed component,
DGSolver::PBTE_NonGraySMRT_MPI (ref: reference/DGSolver/
PBTE_NonGraySMRT_MPI.cpp:10-531). The mapping:

  METIS partitions + halo ranks      -> parallel.partition.PartitionPlan,
                                        elements sharded over mesh axis "space"
  MPI_Isend/Irecv/Waitsome exchange  -> ONE lax.psum of the interface-element
    (once per outer iteration,          coefficient buffer over "space"
     ref: :57-181)                      (same once-per-iteration cadence ->
                                        identical block-Jacobi semantics:
                                        cross-partition upwind data is one
                                        iteration stale, exact sweep within)
  OpenMP collapse over ordinates     -> direction slots sharded over axis "dir"
  root-gather residual + MPI_Bcast   -> psum'd norms over both axes (this also
    (ref: :268-315)                     fixes the MFEM port's rank-local
                                        residual bug, SURVEY.md section 2.4)

Each device owns a contiguous block of direction slots x a spatial partition.
Within a partition the sweep uses LOCAL wavefront levels (levelization of the
partition-local upwind subgraph — cross-partition dependencies are lagged, so
they do not constrain the local order; this matches the legacy "per-partition
computation order" semantics).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbte.models import macroscopic
from pbte.parallel import partition as part_mod
from pbte.sweep import planner


class SpatialShardedSolver:
    """Domain-decomposed, ordinate-sharded solver over Mesh(("dir","space"))."""

    def __init__(
        self,
        ops,
        quad,
        tables,
        bc_temps: dict,
        device_mesh,  # jax.sharding.Mesh with axes ("dir", "space")
        dtype=None,
        partition_method: str = "rcb",
        topo=None,  # MeshTopology (for the partitioner); required
        require_bcs: bool = True,
        dirichlet_bcs: dict | None = None,
        diffuse_bcs=None,  # iterable of attrs: legacy BC type 2 (Lambert)
        specular_bcs=None,  # iterable of attrs: legacy BC type 3 (mirror)
        halo_mode: str = "ppermute",  # "ppermute" (neighbor-to-neighbor,
        # O(interface) traffic) | "psum" (legacy all-reduce, O(P*interface))
        force_per_element_factors: bool = False,  # A/B: keep the per-element
        # A^-1 cache even when geometry classes would collapse it (tests
        # validate the class path against this at moderate shapes)
    ):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        if topo is None:
            raise ValueError("SpatialShardedSolver requires the MeshTopology")
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        np_dtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
        self.mesh = device_mesh
        n_dir = device_mesh.shape["dir"]
        n_space = device_mesh.shape["space"]

        self.ne = ops.num_elements
        self.D = D = ops.ndof
        self.nf = nf = ops.faces_per_elem
        self.dim = ops.dim
        self.K = quad.num_directions
        self.BS = BS = tables.num_branches * tables.num_spectral
        self.omega = quad.total_weight

        inv_kn = tables.flat("inv_kn").astype(np.float64)
        vg = tables.flat("vg").astype(np.float64)
        heat_cap = tables.flat("heat_cap").astype(np.float64)
        self.dt_inv = float(inv_kn.max())
        vg_s = vg / self.dt_inv

        # periodic faces: the partner element's value is read LAGGED (the
        # previous outer iterate) whether it lives on this partition or
        # another — the same semantics the single-device solver and the
        # sequential oracle use (cross-partition partners arrive through the
        # already-lagged halo; local partners are gathered from the pre-sweep
        # state). Periodic edges are masked from the local levelization so
        # they cannot close upwind cycles.
        self.has_periodic = bool(ops.periodic.any())
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
            bdry_attrs - set(int(k) for k in bc_temps)
            - set(int(k) for k in dirichlet_bcs)
            - set(diffuse_bcs) - set(specular_bcs)
        )
        if missing and require_bcs:
            raise ValueError(
                f"boundary attributes without isothermal BC: {sorted(missing)}"
            )
        bc_T_glob = np.zeros((self.ne, nf))
        for attr, T in bc_temps.items():
            bc_T_glob[ops.face_attr == int(attr)] = float(T)
        # Dirichlet (legacy type 7): prescribed incoming intensity g —
        # a static per-face source g * int_F phi (ref: reference Project
        # PolyFem/PolyIntegral.hpp Dirichlet branch; mirrors oracle.py:49-52)
        dvec_glob = np.zeros((self.ne, nf, D))
        for attr, gval in dirichlet_bcs.items():
            sel = ops.face_attr == int(attr)
            dvec_glob[sel] = float(gval) * ops.face_int[sel]

        # ---- global direction grouping (slot layout shared by all devices) --
        # (periodic-masked neighbor table: lagged couplings must not close
        # upwind cycles, same as the single-device solver)
        plan = planner.build_plan(
            ops.sweep_neighbor, ops.normals, quad.directions
        )
        self.plan = plan
        G = plan.num_groups
        Km = max(len(d) for d in plan.dirs_of_group)
        Km = -(-Km // n_dir) * n_dir  # pad to multiple of the dir axis
        dirs_pad = np.full((G, Km), -1, dtype=np.int64)
        for g, d in enumerate(plan.dirs_of_group):
            dirs_pad[g, : len(d)] = d
        self.dirs_pad = dirs_pad
        self.G, self.Km = G, Km
        dir_valid = dirs_pad >= 0
        dirs_np = quad.directions[:, : self.dim]
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        rep_dirs = dirs_np[dirs_safe[:, 0]]  # one representative per group

        # ---- spatial partition ---------------------------------------------
        pplan = part_mod.build_plan(topo, n_space, method=partition_method)
        self.pplan = pplan
        Pn, ne_max = pplan.nparts, pplan.ne_max
        ni = max(pplan.num_interface, 1)

        le = pplan.local_elems  # (P, ne_max), -1 padded
        le_safe = np.where(le >= 0, le, 0)
        le_valid = le >= 0

        # local upwind levelization per (partition, group)
        loc_levels_all = []
        L_max = W_max = 1
        for p in range(Pn):
            elems = le[p][le[p] >= 0]
            nloc = len(elems)
            loc_nbr = pplan.nbr_local[p, :nloc]  # (nloc, nf) local ids or -1
            if self.has_periodic:
                # lagged couplings don't constrain the sweep order
                loc_nbr = np.where(ops.periodic[elems], -1, loc_nbr)
            loc_norms = ops.normals[elems]  # (nloc, nf, dim)
            levels = planner.compute_levels(loc_nbr, loc_norms, rep_dirs)  # (G, nloc)
            loc_levels_all.append(levels)
            L_max = max(L_max, int(levels.max()) + 1 if nloc else 1)
            for g in range(G):
                W_max = max(W_max, int(np.bincount(levels[g]).max()) if nloc else 1)
        levels_tab = np.full((Pn, G, L_max, W_max), -1, dtype=np.int32)
        for p in range(Pn):
            lv = loc_levels_all[p]
            for g in range(G):
                for l in range(int(lv[g].max()) + 1 if lv[g].size else 0):
                    el = np.flatnonzero(lv[g] == l)
                    levels_tab[p, g, l, : len(el)] = el

        # ---- per-partition element-last operator tensors -------------------
        mass_loc = ops.mass[le_safe]  # (P, ne_max, D, D)
        fdot_loc = np.einsum(
            "pefd,gkd->pgkef", ops.normals[le_safe], dirs_np[dirs_safe]
        )  # (P, G, Km, ne_max, nf)

        # Transport factors: CLASS-BATCHED when the mesh has few geometry
        # classes after canonical face ordering would not help here (face
        # order is global), but raw element classes still collapse
        # translation-invariant meshes — the per-element cache is
        # P*G*Km*BS*D^2*ne floats (38 GB at hex-16^3, the round-2 flagship
        # blocker). Classes keep it a few MB. Falls
        # back to the per-element cache on genuinely unstructured meshes.
        from pbte.fem import assembly as _assembly

        # The transport operator A = M + vg~(-sum_d s_d S_d
        # + sum_f max(s.n_f,0) Mf_f) is invariant to LOCAL FACE ORDER, so
        # classes are computed on a canonical-face copy: raw face slots are
        # position-dependent (global first-seen numbering) and split
        # translated elements into thousands of spurious classes — which is
        # what forced the per-element 38 GB cache at flagship scale. All
        # per-face tables below
        # (coupling, fdot, bc) keep the RAW order; only the A build reads
        # the canonical representatives.
        ops_c = _assembly.permute_faces(
            ops, _assembly.canonical_face_perm(ops)
        )
        cls_c = _assembly.element_classes(ops_c)
        cls_raw = _assembly.element_classes(ops)
        if int(cls_c.max()) <= int(cls_raw.max()):
            cls_glob, cls_ops = cls_c, ops_c
        else:
            cls_glob, cls_ops = cls_raw, ops
        ncls = int(cls_glob.max()) + 1
        self._spatial_cls = None
        a_inv = None
        a_cls = None
        cls_loc = None
        if (
            ncls <= 64 and ncls * 4 <= self.ne
            and not force_per_element_factors
        ):
            self._spatial_cls = cls_glob
            reps = np.array(
                [int(np.flatnonzero(cls_glob == c)[0]) for c in range(ncls)]
            )
            stiff_r = cls_ops.stiff[reps]
            fmass_r = cls_ops.face_mass[reps]
            mass_r = cls_ops.mass[reps]
            norm_r = cls_ops.normals[reps]
            a_cls = np.empty((G, Km, BS, ncls, D, D), dtype=np_dtype)
            for g in range(G):
                dk = dirs_np[dirs_safe[g]]
                fd = np.einsum("cfd,kd->ckf", norm_r, dk)
                G_k = -np.einsum("kd,cdij->ckij", dk, stiff_r) + np.einsum(
                    "ckf,cfij->ckij", np.maximum(fd, 0.0), fmass_r
                )
                A = (
                    mass_r[:, None, None]
                    + vg_s[None, None, :, None, None] * G_k[:, :, None]
                )  # (ncls, Km, BS, D, D)
                a_cls[g] = np.linalg.inv(A).transpose(1, 2, 0, 3, 4)
            # a_cls[g]: (Km, BS, ncls, D, D)
            cls_loc = np.where(
                le_valid, cls_glob[le_safe], 0
            ).astype(np.int32)  # (P, ne_max)
        else:
            # per-element A^-1 (partition-local), element-last
            a_inv = np.empty((Pn, G, Km, BS, D, D, ne_max), dtype=np_dtype)
            stiff_loc = ops.stiff[le_safe]  # (P, ne_max, dim, D, D)
            fmass_loc = ops.face_mass[le_safe]  # (P, ne_max, nf, D, D)
            for p in range(Pn):
                for g in range(G):
                    G_g = -np.einsum(
                        "kd,edij->keij", dirs_np[dirs_safe[g]], stiff_loc[p]
                    ) + np.einsum(
                        "kef,efij->keij",
                        np.maximum(fdot_loc[p, g], 0.0),
                        fmass_loc[p],
                    )
                    A_g = (
                        mass_loc[p][None, None]
                        + vg_s[None, :, None, None, None] * G_g[:, None]
                    )
                    a_inv[p, g] = np.linalg.inv(A_g).transpose(0, 1, 3, 4, 2)

        # interface ownership: for each interface element, local index if owned
        iface_src = np.full((Pn, ni), -1, dtype=np.int32)
        for idx, e in enumerate(pplan.interface):
            p = pplan.part[e]
            iface_src[p, idx] = pplan.local_of_global[e]

        # ---- neighbor-to-neighbor halo plan (ppermute) ---------------------
        # The all-reduce halo (psum of a full (ni,) buffer over every space
        # shard) moves O(P * ni); real halos are O(neighbors). Bucket the
        # ordered partition pairs by RING SHIFT (q - p) mod P: each shift is
        # ONE lax.ppermute of a compact per-pair buffer — sender p packs the
        # interface elements partition (p+s) reads from it, receiver scatters
        # them into its halo slots. Analog of the reference's per-neighbor
        # Isend/Irecv lists (ref: reference/DGSolver/PBTE_NonGraySMRT_MPI.cpp:
        # 57-181), expressed as XLA collectives.
        pair_slots = {}  # (src, dst) -> sorted interface-buffer indices
        for q in range(Pn):
            used = np.unique(pplan.nbr_iface[q][pplan.nbr_iface[q] >= 0])
            for idx in used:
                e = int(pplan.interface[idx])
                psrc = int(pplan.part[e])
                if psrc != q:
                    pair_slots.setdefault((psrc, q), []).append(int(idx))
        shifts = sorted({(q - p) % Pn for (p, q) in pair_slots}) or [0]
        n_sh = len(shifts)
        Ms = max(
            (len(v) for v in pair_slots.values()), default=1
        )
        halo_send = np.zeros((Pn, n_sh, Ms), dtype=np.int32)
        halo_recv = np.full((Pn, n_sh, Ms), ni, dtype=np.int32)  # ni = drop
        for (p, q), slots in pair_slots.items():
            s_i = shifts.index((q - p) % Pn)
            slots = sorted(slots)
            locs = [
                int(pplan.local_of_global[pplan.interface[idx]])
                for idx in slots
            ]
            halo_send[p, s_i, : len(slots)] = locs
            halo_recv[q, s_i, : len(slots)] = slots
        self._halo_shifts = shifts
        self.halo_bytes_per_shard = (
            sum(len(v) for v in pair_slots.values()) / max(Pn, 1)
        )
        if halo_mode not in ("ppermute", "psum"):
            raise ValueError(f"unknown halo_mode: {halo_mode}")
        self.halo_mode = halo_mode

        # ---- lagged reflective BCs (legacy types 2/3) ----------------------
        # Same closures as the single-device solver (source_iteration.py
        # reflective tables): contributions built from the PREVIOUS outer
        # iterate. New here: the diffuse hemisphere flux needs a psum over
        # the "dir" axis (outgoing directions live on every dir shard) and
        # the specular mirror slot may live on another dir shard (all_gather
        # of the boundary-face values). Face lists are partition-local.
        w_glob = quad.weights
        dif_tabs = None
        spc_tabs = None

        def _part_rows(attr_list):
            rows = np.argwhere(
                np.isin(ops.face_attr, attr_list)
                & (ops.neighbor < 0) & ops.face_valid
            )
            per_part = [[] for _ in range(Pn)]
            for e, f in rows:
                per_part[int(pplan.part[e])].append((int(e), int(f)))
            return rows, per_part

        if self._dif_on:
            rows_d, per_d = _part_rows(diffuse_bcs)
            if len(rows_d) == 0:
                self._dif_on = False
            else:
                Pd = max(1, max(len(s) for s in per_d))
                d_pos = np.zeros((Pn, Pd), np.int32)
                d_fint = np.zeros((Pn, Pd, D))
                d_norm = np.zeros((Pn, Pd))
                d_cin = np.zeros((Pn, G, Km, Pd))
                d_wplus = np.zeros((Pn, G, Km, Pd))
                for p in range(Pn):
                    for j, (e, f) in enumerate(per_d[p]):
                        n = ops.normals[e, f]
                        sdotn = np.einsum(
                            "gkd,d->gk", dirs_np[dirs_safe], n
                        ) * dir_valid
                        cn = (
                            w_glob * np.maximum(-dirs_np @ n, 0.0)
                        ).sum()  # incoming-hemisphere weight
                        areaF = ops.face_int[e, f].sum()
                        d_pos[p, j] = pplan.local_of_global[e]
                        d_fint[p, j] = ops.face_int[e, f]
                        d_norm[p, j] = 1.0 / max(cn * areaF, 1e-300)
                        d_cin[p, :, :, j] = np.minimum(sdotn, 0.0)
                        d_wplus[p, :, :, j] = (
                            w_glob[dirs_safe] * dir_valid
                            * np.maximum(sdotn, 0.0)
                        )
                dif_tabs = dict(pos=d_pos, fint=d_fint, norm=d_norm,
                                cin=d_cin, wplus=d_wplus)

        if self._spc_on:
            from pbte.validation.oracle import mirror_direction_map

            rows_s, per_s = _part_rows(specular_bcs)
            if len(rows_s) == 0:
                self._spc_on = False
            else:
                n_all = ops.normals[rows_s[:, 0], rows_s[:, 1]]
                if np.abs(np.abs(n_all).max(axis=-1) - 1.0).max() > 1e-9:
                    raise ValueError("specular faces must be axis-aligned")
                axes = set(int(a) for a in np.argmax(np.abs(n_all), axis=-1))
                mirror = mirror_direction_map(quad, self.dim, axes=axes)
                g_of_dir = np.zeros(quad.num_directions, dtype=np.int64)
                k_of_dir = np.zeros(quad.num_directions, dtype=np.int64)
                gg, kk = np.nonzero(dir_valid)
                g_of_dir[dirs_pad[gg, kk]] = gg
                k_of_dir[dirs_pad[gg, kk]] = kk
                Ps = max(1, max(len(s) for s in per_s))
                s_pos = np.zeros((Pn, Ps), np.int32)
                s_fm = np.zeros((Pn, Ps, D, D))
                s_cin = np.zeros((Pn, G, Km, Ps))
                s_gk = np.zeros((Pn, G, Km, Ps), np.int32)
                for p in range(Pn):
                    for j, (e, f) in enumerate(per_s[p]):
                        n = ops.normals[e, f]
                        ax = int(np.argmax(np.abs(n)))
                        sdotn = np.einsum(
                            "gkd,d->gk", dirs_np[dirs_safe], n
                        ) * dir_valid
                        km_glob = np.where(
                            dir_valid, mirror[ax, dirs_safe], 0
                        )
                        s_pos[p, j] = pplan.local_of_global[e]
                        s_fm[p, j] = ops.face_mass[e, f]
                        s_cin[p, :, :, j] = np.minimum(sdotn, 0.0)
                        s_gk[p, :, :, j] = (
                            g_of_dir[km_glob] * Km + k_of_dir[km_glob]
                        )
                spc_tabs = dict(pos=s_pos, fm=s_fm, cin=s_cin, gk=s_gk)

        # macroscopic weights on slots (padded slots zero)
        mw = macroscopic.macro_weights(quad, tables)
        mw_slots = np.where(dir_valid[..., None], mw[dirs_safe], 0.0)  # (G, Km, BS)

        # ---- device placement ----------------------------------------------
        def spec_for(axes):
            return NamedSharding(self.mesh, P(*axes))

        def puts(a, axes, dt=np_dtype):
            return jax.device_put(
                np.ascontiguousarray(a, dtype=dt), spec_for(axes)
            )

        S, DIR = "space", "dir"
        self.consts = dict(
            mass_t=puts(
                np.moveaxis(np.swapaxes(ops.mass, -1, -2)[le_safe] *
                            le_valid[..., None, None], 1, -1),
                (S,),
            ),  # (P, D, D, ne_max)
            face_int=puts(
                np.moveaxis(ops.face_int[le_safe] * le_valid[..., None, None], 1, -1),
                (S,),
            ),  # (P, nf, D, ne_max)
            coupling=puts(
                np.moveaxis(
                    ops.coupling[le_safe] * le_valid[..., None, None, None], 1, -1
                ),
                (S,),
            ),  # (P, nf, D, D, ne_max)
            nbr_local=puts(np.swapaxes(pplan.nbr_local, 1, 2), (S,), np.int32),
            nbr_iface=puts(np.swapaxes(pplan.nbr_iface, 1, 2), (S,), np.int32),
            bc_T=puts(np.swapaxes(bc_T_glob[le_safe] * le_valid[..., None], 1, 2), (S,)),
            **(
                {"dvec": puts(
                    np.transpose(
                        dvec_glob[le_safe] * le_valid[..., None, None],
                        (0, 2, 3, 1),
                    ), (S,)
                )}  # (P, nf, D, ne_max)
                if self.has_dirichlet else {}
            ),
            **(
                {"per_loc": puts(
                    np.swapaxes(
                        ops.periodic[le_safe] & le_valid[..., None], 1, 2
                    ), (S,), np.bool_
                )}  # (P, nf, ne_max)
                if self.has_periodic else {}
            ),
            basis_int=puts(ops.basis_int[le_safe] * le_valid[..., None], (S,)),
            elem_valid=puts(le_valid, (S,), np.bool_),
            vg=puts(np.broadcast_to(vg_s, (1, BS)).copy(), ()),
            src_w=puts((inv_kn * heat_cap / (self.omega * self.dt_inv))[None], ()),
            relax_w=puts((1.0 - inv_kn / self.dt_inv)[None], ()),
            bc_w=puts((heat_cap / self.omega)[None], ()),
            macro_w=puts(mw_slots[None], (None, None, DIR)),  # (1, G, Km, BS)
            levels=puts(levels_tab, (S,), np.int32),  # (P, G, L, W)
            fdot=puts(
                np.moveaxis(fdot_loc, 3, -1), (S, None, DIR)
            ),  # (P, G, Km, nf, ne_max)
            **(
                {"a_cls": puts(a_cls[None], (None, None, DIR)),
                 "cls_loc": puts(cls_loc, (S,), np.int32)}
                if a_cls is not None
                else {"a_inv": puts(a_inv, (S, None, DIR))}
            ),  # class factors (1, G, Km, BS, ncls, D, D) or per-element
            # (P, G, Km, BS, D, D, ne_max)
            iface_src=puts(iface_src, (S,), np.int32),  # (P, ni)
            halo_send=puts(halo_send, (S,), np.int32),  # (P, n_sh, Ms)
            halo_recv=puts(halo_recv, (S,), np.int32),  # (P, n_sh, Ms)
            **(
                {
                    "dif_pos": puts(dif_tabs["pos"], (S,), np.int32),
                    "dif_fint": puts(dif_tabs["fint"], (S,)),
                    "dif_norm": puts(dif_tabs["norm"], (S,)),
                    "dif_cin": puts(dif_tabs["cin"], (S, None, DIR)),
                    "dif_wplus": puts(dif_tabs["wplus"], (S, None, DIR)),
                }
                if self._dif_on else {}
            ),
            **(
                {
                    "spc_pos": puts(spc_tabs["pos"], (S,), np.int32),
                    "spc_fm": puts(spc_tabs["fm"], (S,)),
                    "spc_cin": puts(spc_tabs["cin"], (S, None, DIR)),
                    "spc_gk": puts(spc_tabs["gk"], (S, None, DIR), np.int32),
                }
                if self._spc_on else {}
            ),
        )
        self.ne_max = ne_max
        self.ni = ni
        # host-side references for output-time reconstruction (u gather,
        # heat flux); not used in the device step
        self._quad = quad
        self._tables = tables
        self._basis_int_glob = ops.basis_int.copy()
        self._mesh_data = topo.mesh
        self._order = ops.order
        self._step = jax.jit(self._step_impl)

    # ------------------------------------------------------------------

    def initial_state(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        u = jax.device_put(
            jnp.zeros(
                (self.pplan.nparts, self.G, self.Km, self.BS, self.D, self.ne_max),
                dtype=self.dtype,
            ),
            NamedSharding(self.mesh, P("space", None, "dir")),
        )
        Tc = jax.device_put(
            jnp.zeros((self.pplan.nparts, self.ne_max, self.D), dtype=self.dtype),
            NamedSharding(self.mesh, P("space")),
        )
        Tv = jax.device_put(
            jnp.zeros((self.pplan.nparts, self.ne_max), dtype=self.dtype),
            NamedSharding(self.mesh, P("space")),
        )
        return u, Tc, Tv

    def _step_impl(self, c, u, Tc, Tv_prev):
        import jax
        import jax.numpy as jnp
        from jax import lax
        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        S, DIR = "space", "dir"
        nf, ne_max, ni, D = self.nf, self.ne_max, self.ni, self.D

        in_specs = (
            dict(
                mass_t=P(S), face_int=P(S), coupling=P(S),
                nbr_local=P(S), nbr_iface=P(S), bc_T=P(S), basis_int=P(S),
                elem_valid=P(S), vg=P(), src_w=P(), relax_w=P(), bc_w=P(),
                macro_w=P(None, None, DIR), levels=P(S),
                fdot=P(S, None, DIR), iface_src=P(S),
                halo_send=P(S), halo_recv=P(S),
                **({"dvec": P(S)} if self.has_dirichlet else {}),
                **({"per_loc": P(S)} if self.has_periodic else {}),
                **(
                    {"dif_pos": P(S), "dif_fint": P(S), "dif_norm": P(S),
                     "dif_cin": P(S, None, DIR),
                     "dif_wplus": P(S, None, DIR)}
                    if self._dif_on else {}
                ),
                **(
                    {"spc_pos": P(S), "spc_fm": P(S),
                     "spc_cin": P(S, None, DIR), "spc_gk": P(S, None, DIR)}
                    if self._spc_on else {}
                ),
                **(
                    {"a_cls": P(None, None, DIR), "cls_loc": P(S)}
                    if self._spatial_cls is not None
                    else {"a_inv": P(S, None, DIR)}
                ),
            ),
            P(S, None, DIR),  # u
            P(S),  # Tc
            P(S),  # Tv_prev
        )
        out_specs = (P(S, None, DIR), P(S), P(S), P())

        def device_step(cl, u_l, Tc_l, Tv_prev_l):
            # all locals carry a leading (1,) partition axis from shard_map
            u_l = u_l[0]  # (G, Kl, BS, D, ne_max)
            Tc_l = Tc_l[0]
            Tv_prev_l = Tv_prev_l[0]
            mass_t = cl["mass_t"][0]
            face_int = cl["face_int"][0]
            coupling = cl["coupling"][0]
            nbr_local = cl["nbr_local"][0]
            nbr_iface = cl["nbr_iface"][0]
            bc_T = cl["bc_T"][0]
            basis_int = cl["basis_int"][0]
            elem_valid = cl["elem_valid"][0]
            macro_w = cl["macro_w"][0]
            levels = cl["levels"][0]  # (G, L, W)
            fdot = cl["fdot"][0]  # (G, Kl, nf, ne_max)
            if self._spatial_cls is not None:
                a_inv = cl["a_cls"][0]  # (G, Kl, BS, ncls, D, D)
                cls_loc = cl["cls_loc"][0]  # (ne_max,)
            else:
                a_inv = cl["a_inv"][0]
            iface_src = cl["iface_src"][0]  # (ni,)
            vg = cl["vg"][0]
            src_w = cl["src_w"][0]
            relax_w = cl["relax_w"][0]
            bc_w = cl["bc_w"][0]
            dvec = cl["dvec"][0] if self.has_dirichlet else None
            per_loc = cl["per_loc"][0] if self.has_periodic else None
            # pre-sweep snapshot: lagged source for local periodic partners
            u_prev = u_l if self.has_periodic else None

            # ---- halo exchange: lagged interface coefficients ----
            if self.halo_mode == "psum":
                # legacy all-reduce halo: O(P * ni) traffic (kept for
                # cross-checking the ppermute plan)
                owned = iface_src >= 0
                src = jnp.where(owned, iface_src, 0)
                contrib = jnp.where(
                    owned[None, None, None, None, :], u_l[..., src], 0.0
                )  # (G, Kl, BS, D, ni)
                halo = lax.psum(contrib, S)
            else:
                # neighbor-to-neighbor: one ppermute per partition-graph
                # ring shift; traffic is O(own interface), independent of P
                halo_send = cl["halo_send"][0]  # (n_sh, Ms)
                halo_recv = cl["halo_recv"][0]  # (n_sh, Ms), ni = drop
                Pn = self.pplan.nparts
                halo = jnp.zeros(u_l.shape[:-1] + (ni,), u_l.dtype)
                for s_i, shift in enumerate(self._halo_shifts):
                    buf = u_l[..., halo_send[s_i]]  # (G, Kl, BS, D, Ms)
                    recv = lax.ppermute(
                        buf, S,
                        perm=[(i, (i + shift) % Pn) for i in range(Pn)],
                    )
                    halo = halo.at[..., halo_recv[s_i]].set(
                        recv, mode="drop"
                    )

            TcT = Tc_l.T  # (D, ne_max)

            # ---- lagged reflective closures (types 2/3), from the PRE-sweep
            # state — exactly like the halo. Scattered into a full-length
            # rhs addend consumed per level inside the sweep.
            refl_rhs = None
            if self._dif_on:
                d_pos = cl["dif_pos"][0]  # (Pd,)
                d_fint = cl["dif_fint"][0]  # (Pd, D)
                d_norm = cl["dif_norm"][0]  # (Pd,)
                d_cin = cl["dif_cin"][0]  # (G, Kl, Pd)
                d_wplus = cl["dif_wplus"][0]  # (G, Kl, Pd)
                u_d = u_l[:, :, :, :, d_pos]  # (G, Kl, BS, D, Pd)
                outf = jnp.einsum("gkp,pi,gkbip->bp", d_wplus, d_fint, u_d)
                # full hemisphere: outgoing slots live on every dir shard
                outf = lax.psum(outf, DIR)
                u_in = outf * d_norm[None, :]  # (BS, Pd)
                dif_con = -jnp.einsum(
                    "gkp,b,bp,pi->gkbip", d_cin, vg, u_in, d_fint
                )
                refl_rhs = jnp.zeros(u_l.shape, u_l.dtype)
                refl_rhs = refl_rhs.at[:, :, :, :, d_pos].add(dif_con)
            if self._spc_on:
                s_pos = cl["spc_pos"][0]  # (Ps,)
                s_fm = cl["spc_fm"][0]  # (Ps, D, D)
                s_cin = cl["spc_cin"][0]  # (G, Kl, Ps)
                s_gk = cl["spc_gk"][0]  # (G, Kl, Ps) global flat (g*Km+k)
                u_s = u_l[:, :, :, :, s_pos]  # (G, Kl, BS, D, Ps)
                # the mirror slot may live on another dir shard: gather the
                # (small) boundary-face block over the dir axis
                u_all = lax.all_gather(
                    u_s, DIR, axis=1, tiled=True
                )  # (G, Km, BS, D, Ps)
                u_flat = u_all.reshape((-1,) + u_all.shape[2:])
                Ps_n = s_pos.shape[0]
                u_m = u_flat[
                    s_gk, :, :, jnp.arange(Ps_n)[None, None, :]
                ]  # (G, Kl, Ps, BS, D)
                spc_con = -jnp.einsum(
                    "gkp,b,pij,gkpbj->gkbip", s_cin, vg, s_fm, u_m
                )
                if refl_rhs is None:
                    refl_rhs = jnp.zeros(u_l.shape, u_l.dtype)
                refl_rhs = refl_rhs.at[:, :, :, :, s_pos].add(spc_con)

            def sweep_group(u_g, lv_g, fdot_g, ainv_g):
                # u_g (Kl, BS, D, ne_max)
                def level_body(u_g, level):
                    valid = level >= 0
                    es = jnp.where(valid, level, 0)
                    Mt = mass_t[:, :, es]  # (D, D, W)
                    t_tc = jnp.einsum("ijw,jw->iw", Mt, TcT[:, es])
                    u_e = u_g[:, :, :, es]
                    t_old = jnp.einsum("ijw,kbjw->kbiw", Mt, u_e)
                    rhs = (
                        src_w[None, :, None, None] * t_tc[None, None]
                        + relax_w[None, :, None, None] * t_old
                    )
                    if refl_rhs_g is not None:
                        rhs = rhs + refl_rhs_g[:, :, :, es]
                    for f in range(nf):
                        nl = nbr_local[f, es]
                        nif = nbr_iface[f, es]
                        is_b = (nl < 0) & (nif < 0)
                        fd = fdot_g[:, f, es]
                        cin = jnp.minimum(fd, 0.0)
                        nl_s = jnp.where(nl >= 0, nl, 0)
                        u_loc = u_g[:, :, :, nl_s]
                        if self.has_periodic:
                            # local periodic partner: previous outer iterate
                            u_loc = jnp.where(
                                per_loc[f, es][None, None, None, :],
                                u_prev_g[:, :, :, nl_s],
                                u_loc,
                            )
                        u_rem = halo_g[:, :, :, jnp.where(nif >= 0, nif, 0)]
                        u_nbr = jnp.where((nl >= 0)[None, None, None, :], u_loc, u_rem)
                        cu = jnp.einsum(
                            "ijw,kbjw->kbiw", coupling[f][:, :, es], u_nbr
                        )
                        bterm = (
                            bc_w[None, :, None, None]
                            * bc_T[f, es][None, None, None, :]
                            * face_int[f][:, es][None, None, :, :]
                        )
                        if self.has_dirichlet:
                            # prescribed-intensity source (no heat_cap/omega
                            # closure factor — matches oracle.py:89)
                            bterm = bterm + dvec[f][:, es][None, None]
                        term = jnp.where(is_b[None, None, None, :], bterm, cu)
                        rhs = rhs - vg[None, :, None, None] * cin[:, None, None, :] * term
                    if self._spatial_cls is not None:
                        # class-batched factors gathered by local class id
                        a_es = ainv_g[:, :, cls_loc[es]]  # (Kl, BS, W, D, D)
                        sol = jnp.einsum("kbwij,kbjw->kbiw", a_es, rhs)
                    else:
                        sol = jnp.einsum(
                            "kbijw,kbjw->kbiw", ainv_g[:, :, :, :, es], rhs
                        )
                    idx = jnp.where(valid, es, ne_max)
                    return u_g.at[:, :, :, idx].set(sol, mode="drop"), None

                u_g, _ = lax.scan(level_body, u_g, lv_g)
                return u_g

            outs = []
            for g in range(self.G):
                halo_g = halo[g]
                u_prev_g = u_prev[g] if self.has_periodic else None
                refl_rhs_g = refl_rhs[g] if refl_rhs is not None else None
                outs.append(sweep_group(u_l[g], levels[g], fdot[g], a_inv[g]))
            u_l = jnp.stack(outs)

            # ---- macroscopic closure + global residual ----
            Tc_partial = jnp.einsum("gkb,gkbie->ei", macro_w, u_l)
            Tc_new = lax.psum(Tc_partial, DIR)  # (ne_max, D)
            Tv_new = jnp.einsum("ei,ei->e", Tc_new, basis_int)
            Tv_new = jnp.where(elem_valid, Tv_new, 0.0)

            scale_l = jnp.max(jnp.abs(Tv_new))
            scale = jnp.maximum(
                lax.pmax(lax.pmax(scale_l, S), DIR),
                jnp.finfo(Tv_new.dtype).tiny,
            )
            a = Tv_new / scale
            b = Tv_prev_l / scale
            num = lax.psum(jnp.sum((a - b) ** 2), S)
            den = lax.psum(jnp.sum(a**2), S)
            res = jnp.sqrt(num) / jnp.sqrt(den)

            return (
                u_l[None],
                Tc_new[None],
                Tv_new[None],
                res,
            )

        return shard_map(
            device_step, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )(c, u, Tc, Tv_prev)

    # ------------------------------------------------------------------

    def step(self, u, Tc, Tv_prev):
        return self._step(self.consts, u, Tc, Tv_prev)

    def solve(self, tol=1e-7, max_iter=101, state=None, verbose=True,
              check_every=1, sync_every=10, callback=None,
              checkpoint_path=None, checkpoint_every=25,
              accelerate=None, cycle_hook=None, cycle_every=0):
        """sync_every bounds the async dispatch depth: the XLA CPU backend's
        in-process collectives deadlock (rendezvous timeout) when thousands of
        collective executions are enqueued without a host sync."""
        if cycle_hook and cycle_every > 0 and accelerate == "bicgstab":
            raise ValueError("cycle_hook is a plain-iteration cadence; the "
                             "Krylov outer loop has no outer iterates to "
                             "export (use accelerate='none' with --vtu-every)")
        if accelerate not in (None, "none", "bicgstab"):
            raise ValueError(f"unknown accelerate={accelerate!r}")
        if accelerate == "bicgstab":
            # the sharded step is affine in (u, Tc) — bucketed ppermute
            # halos are linear in the previous iterate (solver/accel.py)
            from pbte.solver import accel

            def step_fn(u, Tc, Tv_prev):
                return self._step(self.consts, u, Tc, Tv_prev)

            save_ckpt = None
            if checkpoint_path:
                import jax
                import jax.numpy as jnp
                from jax.sharding import NamedSharding, PartitionSpec as P

                from pbte.io.checkpoint import accel_ckpt_saver

                save_ckpt = accel_ckpt_saver(
                    checkpoint_path, self,
                    jax.device_put(
                        jnp.zeros((self.pplan.nparts, self.ne_max),
                                  dtype=self.dtype),
                        NamedSharding(self.mesh, P("space")),
                    ),
                )

            u_f, Tc_f, Tv_f, tv_res, nmv = accel.bicgstab_outer(
                step_fn, self.initial_state(), state, tol, max_iter,
                verbose=verbose, callback=callback,
                check_every=check_every, label="pbte:spatial",
                save_ckpt=save_ckpt, ckpt_every=checkpoint_every,
            )
            return SpatialSolveResult(u=u_f, Tc=Tc_f, Tv=Tv_f,
                                      residual=tv_res, iterations=nmv,
                                      solver=self)

        import jax

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
                    print(f"[pbte:spatial] iter {it}, residual = {res:.6e}")
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
        return SpatialSolveResult(
            u=u, Tc=Tc, Tv=prev_Tv, residual=res, iterations=it, solver=self
        )

    def gather_Tc(self, Tc) -> np.ndarray:
        """(P, ne_max, D) device state -> (ne, D) global field."""
        Tc = np.asarray(Tc)
        out = np.zeros((self.ne, self.D), dtype=Tc.dtype)
        for p in range(self.pplan.nparts):
            elems = self.pplan.local_elems[p]
            mask = elems >= 0
            out[elems[mask]] = Tc[p, mask]
        return out

    def u_by_direction(self, u) -> np.ndarray:
        """(P, G, Km, BS, D, ne_max) device state -> (K, BS, ne, D) global,
        direction-major — the layout the multi-rank-comparable dumps use
        (analog of the reference's rank-gathered coefficient blocks,
        ref: src/Utils.cpp:100-148)."""
        u = np.asarray(u)
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=u.dtype)
        for p in range(self.pplan.nparts):
            elems = self.pplan.local_elems[p]
            mask = elems >= 0
            ge = elems[mask]
            for g in range(self.G):
                for k in range(self.Km):
                    d = self.dirs_pad[g, k]
                    if d >= 0:
                        out[d, :, ge, :] = u[p, g, k][:, :, mask].transpose(
                            2, 0, 1
                        )
        return out

    def heat_flux(self, u):
        """Global Qc (dim, ne, D) and Qv (dim, ne) from sharded state."""
        from pbte.models import macroscopic as macro

        ud = self.u_by_direction(u)
        fw = macro.flux_weights(self._quad, self._tables, self.dim)
        Qc = np.einsum("dkb,kbei->dei", fw, ud)
        Qv = np.einsum("dei,ei->de", Qc, self._basis_int_glob)
        return Qc, Qv

    @property
    def element_partition(self) -> np.ndarray:
        """(ne,) owning partition per element (for ParaView pieces)."""
        return self.pplan.part

    def paraview_pieces(self, Tc, u=None):
        """Per-partition LOCAL field blocks for io.vtu.write_pvtu /
        ParaViewCollection.save_pieces — the distributed-export path: each
        piece is built from its shard's state block only, never assembling
        the global (ne, D) field (analog of the reference's per-rank
        ParGridFunction pieces, ref: src/MacroscopicQuantities.cpp:168-271).

        Returns [(elem_ids, {"T": (ne_p, D)}, {"Q": (dim, ne_p, D)}), ...]
        ("Q" present only when u is given)."""
        from pbte.models import macroscopic as macro

        Tc = np.asarray(Tc)  # (P, ne_max, D)
        if u is not None:
            u = np.asarray(u)  # (P, G, Km, BS, D, ne_max)
            fw = macro.flux_weights(self._quad, self._tables, self.dim)
            valid = self.dirs_pad >= 0  # (G, Km)
            # (dim, G, Km, BS) flux weights in slot order, padding zeroed
            fw_pad = (
                fw[:, np.where(valid, self.dirs_pad, 0), :]
                * valid[None, :, :, None]
            )
        pieces = []
        for p in range(self.pplan.nparts):
            elems = self.pplan.local_elems[p]
            mask = elems >= 0
            sf = {"T": Tc[p, mask]}
            vf = {}
            if u is not None:
                Qc_p = np.einsum("dgkb,gkbie->die", fw_pad, u[p])
                vf["Q"] = Qc_p[:, :, mask].transpose(0, 2, 1)
            pieces.append((elems[mask], sf, vf))
        return pieces

    def write_paraview(self, Tc, u=None, name="pbte_fields",
                       root="output/vis", cycle=0, time=None, lod=None,
                       collection=None):
        """Distributed ParaView export: one .vtu piece per partition from
        shard-local blocks, indexed by data.pvtu + a .pvd collection.
        Pass `collection` (a ParaViewCollection) to append a cycle to an
        existing time series; otherwise a fresh collection is created.
        Returns the .pvd path."""
        from pbte.io.vtu import ParaViewCollection

        if collection is None:
            collection = ParaViewCollection(
                self._mesh_data, self._order, name=name, root=root, lod=lod,
            )
        return collection.save_pieces(
            self.paraview_pieces(Tc, u), cycle=cycle, time=time
        )


@dataclasses.dataclass
class SpatialSolveResult:
    u: object
    Tc: object
    Tv: object
    residual: float
    iterations: int
    solver: SpatialShardedSolver

    def Tc_global(self) -> np.ndarray:
        return self.solver.gather_Tc(self.Tc)

    def u_dirs(self) -> np.ndarray:
        return self.solver.u_by_direction(self.u)
