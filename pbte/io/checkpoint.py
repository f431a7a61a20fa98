"""Checkpoint / resume for the outer source iteration.

The reference has NO checkpointing (SURVEY.md section 5); its nearest artifact
is the end-of-run coefficient dump, which contains exactly the state needed
for a restart because the outer iteration is memoryless beyond (u, Tc, Tv).
This module makes that a first-class capability: a single .npz per checkpoint
with the solver state + shape/config fingerprint, verified on load.
"""

from __future__ import annotations

import numpy as np


def _fingerprint(solver) -> dict:
    # cache_policy determines the state LAYOUT of u; a layout-mismatched
    # load must fail here, not as an opaque XLA shape error later
    policy = {"full": 0, "on-the-fly": 1, "eigen": 2}[
        getattr(solver, "cache_policy", "full")
    ]
    fp = dict(
        G=solver.G, Km=solver.Km, BS=solver.BS, D=solver.D, ne=solver.ne,
        K=solver.K, dt_inv=solver.dt_inv,
        ne_pad=getattr(solver, "ne_pad", solver.ne),
        cache_policy=policy,
    )
    if hasattr(solver, "elems_p"):  # SlabLatticeSolver (v = M^T u slabs)
        fp["nparts"] = solver.P
        fp["ne_max"] = solver.ne_loc
        fp["state_kind"] = 2
    if hasattr(solver, "pplan"):  # SpatialShardedSolver
        fp["nparts"] = solver.pplan.nparts
        fp["ne_max"] = solver.ne_max
    if getattr(solver, "sweep_mode", "scan") == "ring":
        # the ring carries the mass-transformed state v = M^T u — a
        # checkpoint of one kind must not silently load into the other
        fp["state_kind"] = 1
    if getattr(solver, "_ring_windowed", False):
        # hull-windowed state is a nested (bucket, segment) tuple with
        # per-segment widths; only added when engaged, so full-slab
        # checkpoints keep their round-3 fingerprint layout
        fp["ring_windowed"] = 1
    if getattr(solver, "_ring_wd", False):
        # supercell WD layout (L, G, Km, BS, W, D') — D' minor
        fp["ring_wd"] = 1
    return fp


def _state_dtype(solver):
    """dtype of the carried u state (the ring may store it bf16)."""
    import jax.numpy as jnp

    if getattr(solver, "_ring_state_bf16", False):
        return jnp.bfloat16
    return solver.dtype


def _expected_u_shape(solver):
    if hasattr(solver, "elems_p"):  # SlabLatticeSolver
        return (solver.P, solver.L, solver.G, solver.Km, solver.D,
                solver.BS, solver.W)
    if hasattr(solver, "pplan"):  # SpatialShardedSolver
        return (solver.pplan.nparts, solver.G, solver.Km, solver.BS,
                solver.D, solver.ne_max)
    if getattr(solver, "sweep_mode", "scan") == "ring":
        # bucketed state: a LIST of per-bucket shapes
        if getattr(solver, "_ring_wd", False):
            return [
                (solver.L, len(gs), km_b, solver.BS, solver.W, solver.D)
                for gs, km_b in solver._ring_buckets
            ]
        if getattr(solver, "_ring_windowed", False):
            # nested: per bucket, per hull-window segment
            return [
                [
                    (l1 - l0, len(gs), km_b, solver.D, solver.BS, Ws)
                    for (l0, l1, _, _, Ws) in solver._ring_segs
                ]
                for gs, km_b in solver._ring_buckets
            ]
        return [
            (solver.L, len(gs), km_b, solver.D, solver.BS, solver.W)
            for gs, km_b in solver._ring_buckets
        ]
    return (solver.G, solver.Km, solver.BS, solver.D, solver.ne_pad)


def _np(a):
    """Host copy, upcast bfloat16 to float32 (lossless; .npy cannot
    round-trip the ml_dtypes extension dtype portably)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def save_checkpoint(path: str, solver, u, Tc, Tv, iteration: int, residual: float):
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(u, (tuple, list)) and len(u) and isinstance(
        u[0], (tuple, list)
    ):  # hull-windowed ring state: (bucket, segment) nesting
        u_fields = {
            f"u_{i}_{s}": _np(seg)
            for i, b in enumerate(u)
            for s, seg in enumerate(b)
        }
        u_fields["u_nbuckets"] = len(u)
        u_fields["u_nsegs"] = len(u[0])
    elif isinstance(u, (tuple, list)):  # bucketed ring state
        u_fields = {f"u_{i}": _np(b) for i, b in enumerate(u)}
        u_fields["u_nbuckets"] = len(u)
    else:
        u_fields = {"u": _np(u)}
    # atomic write: stream to a sibling tmp file, then rename over the
    # final path — a crash mid-save (OOM, preemption) must not destroy the
    # previous good checkpoint, which is the whole point of checkpointing.
    # np.savez appends ".npz" to extensionless paths; mirror that so the
    # replace target matches what np.load will be pointed at.
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            Tc=np.asarray(Tc),
            Tv=np.asarray(Tv),
            iteration=iteration,
            residual=residual,
            **u_fields,
            **{f"fp_{k}": v for k, v in _fingerprint(solver).items()},
        )
    os.replace(tmp, final)


def accel_ckpt_saver(path: str, solver, Tv):
    """save_ckpt closure for Krylov-accelerated solves (accel.bicgstab_outer).

    Tv is not part of the Krylov state; checkpoints carry the zeros leaf the
    caller provides (the resumed solve recomputes Tv). Each solver builds
    its own Tv zeros because the leaf's shape/sharding is solver-specific."""

    def save_ckpt(u, Tc, nmv, res):
        save_checkpoint(path, solver, u, Tc, Tv, nmv, res)

    return save_ckpt


def load_checkpoint(path: str, solver):
    """Returns (state_tuple, iteration, residual); state feeds solver.solve."""
    import jax.numpy as jnp

    data = np.load(path)
    fp = _fingerprint(solver)
    for k, v in fp.items():
        if f"fp_{k}" not in data:
            raise ValueError(f"checkpoint missing fingerprint field {k!r}")
        stored = data[f"fp_{k}"]
        if not np.allclose(stored, v):
            raise ValueError(
                f"checkpoint mismatch: {k} was {stored}, solver has {v}"
            )
    want = _expected_u_shape(solver)
    if isinstance(want, list) and want and isinstance(want[0], list):
        # hull-windowed ring: nested (bucket, segment) tuples saved as
        # u_{bucket}_{segment} fields (see save_checkpoint)
        n = int(data["u_nbuckets"]) if "u_nbuckets" in data else -1
        ns = int(data["u_nsegs"]) if "u_nsegs" in data else -1
        if n != len(want) or ns != len(want[0]):
            raise ValueError(
                f"checkpoint has {n} buckets x {ns} segments, solver "
                f"expects {len(want)} x {len(want[0])}"
            )
        sdt = _state_dtype(solver)
        bufs = []
        for i, ws in enumerate(want):
            segs = []
            for si, w in enumerate(ws):
                arr = data[f"u_{i}_{si}"]
                if tuple(arr.shape) != w:
                    raise ValueError(
                        f"checkpoint u_{i}_{si} has shape "
                        f"{tuple(arr.shape)}, solver expects {w}"
                    )
                segs.append(jnp.asarray(arr, dtype=sdt))
            bufs.append(tuple(segs))
        u = tuple(bufs)
        Tc = jnp.asarray(data["Tc"], dtype=solver.dtype)
        Tv = jnp.asarray(data["Tv"], dtype=solver.dtype)
        return (u, Tc, Tv), int(data["iteration"]), float(data["residual"])
    if isinstance(want, list):  # bucketed ring state
        n = int(data["u_nbuckets"]) if "u_nbuckets" in data else -1
        if n != len(want):
            raise ValueError(
                f"checkpoint has {n} state buckets, solver expects {len(want)}"
            )
        bufs = []
        for i, w in enumerate(want):
            arr = data[f"u_{i}"]
            got = tuple(arr.shape)
            if got != w:
                raise ValueError(
                    f"checkpoint u_{i} has shape {got}, solver expects {w}"
                )
            bufs.append(arr)
        u = tuple(jnp.asarray(a, dtype=_state_dtype(solver)) for a in bufs)
    else:
        if "u" not in data or tuple(data["u"].shape) != want:
            got = tuple(data["u"].shape) if "u" in data else None
            raise ValueError(
                f"checkpoint u has shape {got}, solver expects {want}"
            )
        u = jnp.asarray(data["u"], dtype=solver.dtype)
    Tc = jnp.asarray(data["Tc"], dtype=solver.dtype)
    Tv = jnp.asarray(data["Tv"], dtype=solver.dtype)
    return (u, Tc, Tv), int(data["iteration"]), float(data["residual"])
