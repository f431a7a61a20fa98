"""Sweep planning: upwind DAG levelization + reference-compatible greedy order.

The reference sweeps each ordinate sequentially through a greedy topological
element order (ref: src/AngularSweepOrder.cpp:78-147). On an accelerator the sweep must be
*batched*: for each direction, Kahn-layer the same upwind precedence relation
(element e depends on neighbor n across face f iff outward_normal(e,f)·s < 0)
into wavefront levels; all elements in a level are independent and solved as
one batched op, so the per-ordinate recurrence becomes a `lax.scan` over levels
(SURVEY.md section 5, "sweep sequentiality vs accelerator batching").

Directions with identical upwind sign patterns share the same DAG and hence
identical levels — on axis-aligned meshes there are at most 2^dim distinct
patterns, so the plan stores one level table per *group* plus a (K,) group
index. This is the key memory/compute dedup for the batched sweep.

The greedy order (exact mirror of the reference semantics, including
within-pass readiness propagation in element-index order) is kept for golden
sweep-log parity and for debugging.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class SweepCycleError(RuntimeError):
    """Raised when the upwind precedence graph contains a cycle
    (the reference throws 'sweep ordering stalled';
    ref: src/AngularSweepOrder.cpp:138-142)."""


def upwind_inflow(
    neighbor: np.ndarray, normals: np.ndarray, directions: np.ndarray
) -> np.ndarray:
    """Dependency mask: inflow[k, e, f] = True iff element e's face f receives
    from an interior neighbor for direction k (outward normal dot dir < 0,
    strict — matching the reference's `dot < 0.0`)."""
    dim = normals.shape[-1]
    dots = np.einsum("efd,kd->kef", normals, directions[:, :dim])
    return (dots < 0.0) & (neighbor >= 0)[None, :, :]


def compute_levels(
    neighbor: np.ndarray, normals: np.ndarray, directions: np.ndarray
) -> np.ndarray:
    """Wavefront level of each element per direction: (K, ne) int32.

    level[k, e] = 1 + max(level[k, upwind neighbors]) (0 when none).
    Uses the native C++ Kahn kernel when available (pbte.native),
    falling back to a vectorized numpy fixpoint iteration."""
    try:
        from pbte import native

        levels = native.compute_levels(neighbor, normals, directions)
        if levels is not None:
            return levels
    except ValueError:
        raise SweepCycleError(
            "upwind sweep levelization found a cycle (native kernel)"
        )
    except ImportError:
        pass
    K = directions.shape[0]
    ne, nf = neighbor.shape
    inflow = upwind_inflow(neighbor, normals, directions)  # (K, ne, nf)
    nbr_safe = np.where(neighbor >= 0, neighbor, 0)  # (ne, nf)

    level = np.zeros((K, ne), dtype=np.int64)
    for it in range(ne + 1):
        nbr_lvl = level[:, nbr_safe]  # (K, ne, nf)
        cand = np.where(inflow, nbr_lvl + 1, 0)
        new = cand.max(axis=-1)
        if np.array_equal(new, level):
            return level.astype(np.int32)
        level = new
    raise SweepCycleError(
        "upwind sweep levelization did not converge; the precedence graph "
        "contains a cycle (check mesh connectivity)"
    )


@dataclasses.dataclass
class SweepPlan:
    """Padded level tables, deduplicated by upwind sign pattern.

    levels[g, l, w] = element id (or -1 padding) of slot w in level l of
    direction-group g. All directions k with group_of_dir[k] == g share it.
    """

    group_of_dir: np.ndarray  # (K,) int32
    dirs_of_group: list  # list of (Kg,) int arrays
    levels: np.ndarray  # (G, L_max, W_max) int32, -1 padded
    n_levels: np.ndarray  # (G,) int32
    level_of_elem: np.ndarray  # (G, ne) int32

    @property
    def num_groups(self) -> int:
        return self.levels.shape[0]

    @property
    def max_levels(self) -> int:
        return self.levels.shape[1]

    @property
    def max_width(self) -> int:
        return self.levels.shape[2]

    def padding_ratio(self) -> float:
        """Fraction of padded slots in the level tables (diagnostic)."""
        total = self.levels.size
        real = int((self.levels >= 0).sum())
        return 1.0 - real / total


def dir_slot_maps(dirs_pad: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of the padded (group, slot) -> global-direction table: per
    global direction its group and slot indices, so consumers can build flat
    ``g * Km + k`` lookups into (G*Km, ...)-reshaped slot tensors (the
    specular mirror gather in the ring and slab solvers). Entries for
    directions absent from `dirs_pad` (impossible for a complete plan) stay
    zero."""
    K = int(dirs_pad.max()) + 1
    g_of = np.zeros(K, dtype=np.int64)
    k_of = np.zeros(K, dtype=np.int64)
    gg, kk = np.nonzero(dirs_pad >= 0)
    g_of[dirs_pad[gg, kk]] = gg
    k_of[dirs_pad[gg, kk]] = kk
    return g_of, k_of


def build_plan(
    neighbor: np.ndarray, normals: np.ndarray, directions: np.ndarray
) -> SweepPlan:
    # NOTE on group counts: the exact-signature partition explodes on
    # refined unstructured meshes (unit-cube-tet -r 2: 34 groups for 64
    # directions). Merging groups while keeping the sweep EXACT was
    # investigated and is structurally impossible there: a shared leveling
    # must respect the UNION of the member signatures' upwind DAGs, and on
    # 6-tet meshes every pairwise signature union is already cyclic (the
    # diagonal-face normals flip orientation between nearby directions) —
    # measured: greedy pairwise union merging achieves 34 -> 34. Reducing
    # the replication cost at large G needs group-shared operator storage
    # or lagged cycle-breaking (inexact), not grouping tricks.
    K = directions.shape[0]
    ne = neighbor.shape[0]
    inflow = upwind_inflow(neighbor, normals, directions)

    # group directions by identical dependency pattern
    flat = np.packbits(inflow.reshape(K, -1), axis=1)
    _, group_idx, inverse = np.unique(
        flat, axis=0, return_index=True, return_inverse=True
    )
    G = len(group_idx)
    rep_dirs = directions[group_idx]

    levels_g = compute_levels(neighbor, normals, rep_dirs)  # (G, ne)

    n_levels = levels_g.max(axis=1) + 1
    L_max = int(n_levels.max())
    # width per (g, l)
    W_max = 1
    for g in range(G):
        counts = np.bincount(levels_g[g], minlength=L_max)
        W_max = max(W_max, int(counts.max()))

    tables = np.full((G, L_max, W_max), -1, dtype=np.int32)
    for g in range(G):
        for l in range(int(n_levels[g])):
            elems = np.flatnonzero(levels_g[g] == l)
            tables[g, l, : len(elems)] = elems

    dirs_of_group = [np.flatnonzero(inverse == g) for g in range(G)]
    return SweepPlan(
        group_of_dir=inverse.astype(np.int32),
        dirs_of_group=dirs_of_group,
        levels=tables,
        n_levels=n_levels.astype(np.int32),
        level_of_elem=levels_g.astype(np.int32),
    )


@dataclasses.dataclass
class LatticeInfo:
    """Cartesian-lattice structure of a hex/quad mesh (None-able detection
    result). Enables the SHIFT-STRUCTURED ring sweep: with wavefront level
    l = sum of sweep-transformed integer coordinates and slab slot
    w = j'*nk + k', the upwind neighbor of every element sits in the
    PREVIOUS level's slab at a static per-axis offset (0, nk, or 1) — so
    the ring sweep's neighbor selection needs no one-hot matmuls at all
    (those cost 7-21x the useful coupling flops)."""

    dims: tuple  # (n_0, ..., n_{dim-1}) lattice extents
    coords: np.ndarray  # (ne, dim) integer coordinates
    face_minus: np.ndarray  # (dim,) local-face slot whose outward normal is -e_d
    face_plus: np.ndarray  # (dim,) slot with outward normal +e_d


def detect_lattice(
    neighbor: np.ndarray, normals: np.ndarray, tol: float = 1e-9
) -> LatticeInfo | None:
    """Detect whether (neighbor, normals) describe a Cartesian box lattice.

    Requirements (all verified, not assumed): 2*dim faces per element; every
    element's face-slot normals identical and axis-aligned (the state after
    fem.assembly.canonical_face_perm on a Cartesian hex/quad mesh); integer
    coordinates recovered by following -e_d neighbors form a bijective
    n_0 x ... x n_{dim-1} box whose +-e_d adjacency reproduces the neighbor
    table exactly. Returns None on any mismatch. Periodic faces must already
    be masked to -1 (use ops.sweep_neighbor)."""
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    if nf != 2 * dim or ne < 1:
        return None
    n0 = normals[0]
    scale = max(float(np.abs(n0).max()), 1e-300)
    if float(np.abs(normals - n0).max()) > tol * scale:
        return None
    face_minus = np.full(dim, -1, dtype=np.int64)
    face_plus = np.full(dim, -1, dtype=np.int64)
    for f in range(nf):
        v = n0[f]
        ax = int(np.argmax(np.abs(v)))
        unit = np.zeros(dim)
        unit[ax] = np.sign(v[ax])
        if float(np.abs(v - unit).max()) > tol:
            return None
        tgt = face_plus if unit[ax] > 0 else face_minus
        if tgt[ax] >= 0:
            return None
        tgt[ax] = f
    if (face_minus < 0).any() or (face_plus < 0).any():
        return None
    # coordinate along axis d = chain distance from the -d boundary
    coords = np.zeros((ne, dim), dtype=np.int64)
    for d in range(dim):
        nbr = neighbor[:, face_minus[d]]
        has = nbr >= 0
        nbr_s = np.where(has, nbr, 0)
        c = np.zeros(ne, dtype=np.int64)
        for _ in range(ne + 1):
            new = np.where(has, c[nbr_s] + 1, 0)
            if np.array_equal(new, c):
                break
            c = new
        else:
            return None  # cyclic chain (unmasked periodic?)
        coords[:, d] = c
    dims = coords.max(axis=0) + 1
    if int(np.prod(dims)) != ne:
        return None
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * dims[d + 1]
    lin = coords @ strides
    if len(np.unique(lin)) != ne:
        return None
    elem_at = np.empty(ne, dtype=np.int64)
    elem_at[lin] = np.arange(ne)
    # full adjacency verification against the lattice
    for d in range(dim):
        for sign, faces in ((1, face_plus), (-1, face_minus)):
            c2 = coords.copy()
            c2[:, d] += sign
            inside = (c2[:, d] >= 0) & (c2[:, d] < dims[d])
            lin2 = np.clip(c2 @ strides, 0, ne - 1)
            expect = np.where(inside, elem_at[lin2], -1)
            if not np.array_equal(neighbor[:, faces[d]], expect):
                return None
    return LatticeInfo(
        dims=tuple(int(x) for x in dims),
        coords=coords,
        face_minus=face_minus,
        face_plus=face_plus,
    )


def greedy_orders(
    neighbor: np.ndarray, normals: np.ndarray, directions: np.ndarray
) -> list:
    """Exact mirror of the reference's greedy sweep ordering
    (ref: src/AngularSweepOrder.cpp:93-144): repeated passes over elements in
    index order; an element is ready when every interior-face neighbor with
    outward_normal·dir < 0 is already processed; processing within a pass makes
    later elements ready in the same pass; a pass with no progress raises."""
    K = directions.shape[0]
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    try:
        from pbte import native

        out = native.greedy_orders(neighbor, normals, directions)
        if out is not None:
            return [out[k] for k in range(K)]
    except ValueError:
        raise SweepCycleError("angular sweep ordering stalled (native kernel)")
    except ImportError:
        pass
    orders = []
    for k in range(K):
        dots = normals @ directions[k, :dim]  # (ne, nf)
        upwind = (dots < 0.0) & (neighbor >= 0)
        processed = np.zeros(ne, dtype=bool)
        order = []
        while len(order) < ne:
            progressed = False
            for e in range(ne):
                if processed[e]:
                    continue
                deps = neighbor[e][upwind[e]]
                if np.all(processed[deps]):
                    order.append(e)
                    processed[e] = True
                    progressed = True
            if not progressed:
                raise SweepCycleError(
                    "angular sweep ordering stalled; check mesh connectivity"
                )
        orders.append(np.asarray(order, dtype=np.int32))
    return orders


def write_sweep_orders(quad, topo, path: str) -> None:
    """Golden-format sweep order dump (ref: src/AngularSweepOrder.cpp:149-181)."""
    import os

    # periodic pairs are lagged couplings, not sweep dependencies — mask them
    # exactly as the solver does (ops.sweep_neighbor)
    nbr = np.where(topo.elem_face_periodic, -1, topo.elem_neighbor)
    orders = greedy_orders(nbr, topo.normals, quad.directions)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Sweep order per direction\n")
        f.write(f"dimension: {topo.mesh.dim}\n")
        f.write(f"elements: {topo.mesh.num_elements}\n")
        f.write(f"directions: {quad.num_directions}\n\n")
        for k, order in enumerate(orders):
            f.write(
                f"dir {k} theta={quad.polar[k]:g} phi={quad.azimuth[k]:g} "
                f"w={quad.weights[k]:g} order:"
            )
            for e in order:
                f.write(f" {e}")
            f.write("\n")
