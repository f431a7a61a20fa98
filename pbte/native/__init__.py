"""Native (C++) host-side kernels, loaded via ctypes.

The reference implements its schedulers/partitioners in C++; this package
provides the framework's native equivalents for host-side setup hot paths
(sweep levelization, greedy ordering, inflow signatures). The library is
compiled on demand with g++ (no pybind11 in this environment) and cached
next to the source; every entry point has a pure-numpy fallback in
pbte.sweep.planner, selected automatically when compilation is
unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()


def _build_and_load(src, lib_path, extra_flags=(), timeout=120):
    """Shared compile-if-stale + ctypes-load path for every native module.

    The cached .so is valid only if its recorded source hash matches
    (mtimes are unreliable: a fresh checkout stamps all files identically).
    Portable -O3 only: the binary is a build cache, but -march=native
    output can SIGILL if the cache directory moves between machines.
    Returns the loaded CDLL or None (callers fall back to numpy).
    """
    stamp = lib_path + ".sha256"
    with open(src, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()
    fresh = False
    try:
        with open(stamp) as f:
            fresh = f.read().strip() == src_hash and os.path.exists(lib_path)
    except OSError:
        pass
    if not fresh:
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            *extra_flags, src, "-o", lib_path + ".tmp",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=timeout)
            os.replace(lib_path + ".tmp", lib_path)
            with open(stamp, "w") as f:
                f.write(src_hash)
        except (subprocess.SubprocessError, OSError):
            return None
    try:
        return ctypes.CDLL(lib_path)
    except OSError:
        return None


_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64

_lib = None
_tried = False


def get_lib():
    """Returns the loaded sweep-kernels library or None (fallback to numpy)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _build_and_load(
            os.path.join(_HERE, "sweep_native.cpp"),
            os.path.join(_HERE, "_sweep_native.so"),
        )
        if lib is None:
            return None
        lib.pbte_compute_levels.restype = ctypes.c_int32
        lib.pbte_compute_levels.argtypes = [
            _i64, _i64, _i64, _i64, _i32p, _f64p, _f64p, _i32p,
        ]
        lib.pbte_greedy_orders.restype = ctypes.c_int32
        lib.pbte_greedy_orders.argtypes = [
            _i64, _i64, _i64, _i64, _i32p, _f64p, _f64p, _i32p,
        ]
        lib.pbte_inflow_signature.restype = None
        lib.pbte_inflow_signature.argtypes = [
            _i64, _i64, _i64, _i64, _i32p, _f64p, _f64p, _u8p, _i64,
        ]
        _lib = lib
        return _lib


def compute_levels(neighbor, normals, directions):
    """Native Kahn levelization; returns (K, ne) int32 or None if unavailable.

    Raises planner.SweepCycleError-compatible ValueError on cycles (caller
    translates)."""
    lib = get_lib()
    if lib is None:
        return None
    neighbor = np.ascontiguousarray(neighbor, dtype=np.int32)
    normals = np.ascontiguousarray(normals, dtype=np.float64)
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    dirs = np.ascontiguousarray(directions[:, :dim], dtype=np.float64)
    K = len(dirs)
    levels = np.empty((K, ne), dtype=np.int32)
    rc = lib.pbte_compute_levels(ne, nf, dim, K, neighbor, normals, dirs, levels)
    if rc < 0:
        raise ValueError("cycle")
    return levels


def greedy_orders(neighbor, normals, directions):
    """Native greedy ordering; returns (K, ne) int32 or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    neighbor = np.ascontiguousarray(neighbor, dtype=np.int32)
    normals = np.ascontiguousarray(normals, dtype=np.float64)
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    dirs = np.ascontiguousarray(directions[:, :dim], dtype=np.float64)
    K = len(dirs)
    orders = np.empty((K, ne), dtype=np.int32)
    rc = lib.pbte_greedy_orders(ne, nf, dim, K, neighbor, normals, dirs, orders)
    if rc < 0:
        raise ValueError("cycle")
    return orders


def inflow_signatures(neighbor, normals, directions):
    """Native packed inflow-bit signatures (K, stride) uint8, or None."""
    lib = get_lib()
    if lib is None:
        return None
    neighbor = np.ascontiguousarray(neighbor, dtype=np.int32)
    normals = np.ascontiguousarray(normals, dtype=np.float64)
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    dirs = np.ascontiguousarray(directions[:, :dim], dtype=np.float64)
    K = len(dirs)
    stride = (ne * nf + 7) // 8
    packed = np.empty((K, stride), dtype=np.uint8)
    lib.pbte_inflow_signature(ne, nf, dim, K, neighbor, normals, dirs, packed, stride)
    return packed


# ---------------------------------------------------------------------------
# C++ multilevel k-way partitioner (the METIS-recipe native path)
# ---------------------------------------------------------------------------

_part_lib = None
_part_tried = False


def get_partition_lib():
    """ctypes handle to the C++ multilevel partitioner, or None."""
    global _part_lib, _part_tried
    with _lock:
        if _part_lib is not None or _part_tried:
            return _part_lib
        _part_tried = True
        lib = _build_and_load(
            os.path.join(_HERE, "partition_native.cpp"),
            os.path.join(_HERE, "_partition_native.so"),
        )
        if lib is None:
            return None
        lib.pbte_partition_multilevel.restype = ctypes.c_int32
        lib.pbte_partition_multilevel.argtypes = [
            _i64, _i64, _i32p, _i64, _i64, _i64, ctypes.c_double, _i32p,
        ]
        _part_lib = lib
        return _part_lib


def partition_multilevel(neighbor, nparts, seed=0,
                         coarse_target_per_part=30, max_ratio=1.03):
    """Native multilevel k-way partition of the element dual graph;
    returns (ne,) int32 or None when the native lib is unavailable."""
    lib = get_partition_lib()
    if lib is None:
        return None
    neighbor = np.ascontiguousarray(neighbor, dtype=np.int32)
    ne, nf = neighbor.shape
    out = np.empty(ne, dtype=np.int32)
    rc = lib.pbte_partition_multilevel(
        ne, nf, neighbor, int(nparts), int(seed),
        int(coarse_target_per_part), float(max_ratio), out,
    )
    if rc != 0:
        return None
    return out


# ---------------------------------------------------------------------------
# C++ reference-mirror solver (the measured bench baseline)
# ---------------------------------------------------------------------------

_solver_lib = None
_solver_tried = False


def get_solver_lib():
    """ctypes handle to the C++ source-iteration solver, or None."""
    global _solver_lib, _solver_tried
    with _lock:
        if _solver_lib is not None or _solver_tried:
            return _solver_lib
        _solver_tried = True
        lib = _build_and_load(
            os.path.join(_HERE, "solver_native.cpp"),
            os.path.join(_HERE, "_solver_native.so"),
            extra_flags=("-fopenmp",), timeout=180,
        )
        if lib is None:
            return None
        lib.pbte_cpp_source_iteration.restype = ctypes.c_int32
        lib.pbte_cpp_source_iteration.argtypes = (
            [_i64] * 7 + [ctypes.c_int32]
            + [_i32p, _i32p]
            + [_f64p] * 13
            + [ctypes.c_double, ctypes.c_double]
            + [_f64p] * 5
        )
        _solver_lib = lib
        return _solver_lib


def cpp_source_iteration(ops, quad, tables, bc_temps, n_iter,
                         use_full_lu=True, state=None):
    """Run the C++ reference-mirror solver; returns (u, Tc, Tv, residuals,
    iter_seconds) or None when the native lib is unavailable.

    Mirrors the reference algorithm exactly (same operators, same lagged-Tc
    source iteration; ref: src/PBTESolver.cpp:208-332) — the measured
    baseline bench.py compares the JAX solver against."""
    if ops.periodic.any():
        raise NotImplementedError(
            "the C++ baseline solver does not support periodic meshes"
        )
    lib = get_solver_lib()
    if lib is None:
        return None
    from pbte.models import macroscopic
    from pbte.sweep import planner

    ne, D, nf, dim = ops.num_elements, ops.ndof, ops.faces_per_elem, ops.dim
    K = quad.num_directions
    inv_kn = np.ascontiguousarray(tables.flat("inv_kn"), dtype=np.float64)
    vg = np.ascontiguousarray(tables.flat("vg"), dtype=np.float64)
    heat_cap = np.ascontiguousarray(tables.flat("heat_cap"), dtype=np.float64)
    BS = len(inv_kn)
    dt_inv = float(inv_kn.max())
    dirs = np.ascontiguousarray(quad.directions[:, :dim], dtype=np.float64)
    orders = planner.greedy_orders(ops.neighbor, ops.normals, quad.directions)
    orders = np.ascontiguousarray(orders, dtype=np.int32)
    fdot = np.ascontiguousarray(
        np.einsum("efd,kd->kef", ops.normals, dirs), dtype=np.float64
    )
    mw = np.ascontiguousarray(
        macroscopic.macro_weights(quad, tables), dtype=np.float64
    )
    bc_T = np.zeros((ne, nf))
    for attr, T in bc_temps.items():
        bc_T[ops.face_attr == int(attr)] = float(T)

    if state is None:
        u = np.zeros((K, BS, ne, D))
        Tc = np.zeros((ne, D))
        Tv = np.zeros(ne)
    else:
        u, Tc, Tv = (np.ascontiguousarray(a, dtype=np.float64) for a in state)
    resid = np.zeros(n_iter)
    secs = np.zeros(n_iter)
    rc = lib.pbte_cpp_source_iteration(
        ne, nf, D, dim, K, BS, n_iter, 1 if use_full_lu else 0,
        np.ascontiguousarray(ops.neighbor, dtype=np.int32), orders,
        dirs, fdot,
        np.ascontiguousarray(ops.mass, dtype=np.float64),
        np.ascontiguousarray(ops.stiff, dtype=np.float64),
        np.ascontiguousarray(ops.face_mass, dtype=np.float64),
        np.ascontiguousarray(ops.face_int, dtype=np.float64),
        np.ascontiguousarray(ops.coupling, dtype=np.float64),
        np.ascontiguousarray(bc_T, dtype=np.float64),
        np.ascontiguousarray(ops.basis_int, dtype=np.float64),
        inv_kn, vg, heat_cap, mw, dt_inv, float(quad.total_weight),
        u, Tc, Tv, resid, secs,
    )
    if rc != 0:
        raise RuntimeError(f"pbte_cpp_source_iteration failed rc={rc}")
    return u, Tc, Tv, resid, secs
