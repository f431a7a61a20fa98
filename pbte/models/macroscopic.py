"""Macroscopic closure: Tc / Tv / Qc / Qv reductions and residual.

JAX replacement for pbte::MacroscopicQuantities
(ref: src/MacroscopicQuantities.cpp:104-166). The reference accumulates per
ordinate inside the sweep loops; here the whole reduction is a single einsum
over the (K, BS) ordinate-band axes — which is also where the `psum` goes when
those axes are sharded (SURVEY.md section 2.3).

Weights (ref: src/MacroscopicQuantities.cpp:116-127):
    factor[k, bs] = invKn[bs] * w[k] * dw[bs] / C_V
    Tc[e, i]      = sum_{k,bs} factor * u[k, bs, e, i]
    Qc[d, e, i]   = sum_{k,bs} factor * vg[bs] * s[k, d] * u[k, bs, e, i]
    Tv[e]         = sum_i Tc[e, i] * int_K p_i      (cell averages)
    residual      = ||Tv - Tv_prev||_2 / ||Tv||_2
"""

from __future__ import annotations

import numpy as np


def macro_weights(quad, tables) -> np.ndarray:
    """(K, BS) temperature accumulation weights."""
    inv_kn = tables.flat("inv_kn")
    dw = tables.flat("dw")
    return np.outer(quad.weights, inv_kn * dw) / tables.heat_cap_v


def flux_weights(quad, tables, dim: int) -> np.ndarray:
    """(dim, K, BS) heat-flux accumulation weights."""
    base = macro_weights(quad, tables)  # (K, BS)
    vg = tables.flat("vg")
    return np.einsum("kd,kb,b->dkb", quad.directions[:, :dim], base, vg)


def compute_tc(u, weights):
    """u (K, BS, ne, D), weights (K, BS) -> Tc (ne, D)."""
    import jax.numpy as jnp

    return jnp.einsum("kb,kbei->ei", weights, u)


def compute_tv(Tc, basis_int):
    import jax.numpy as jnp

    return jnp.einsum("ei,ei->e", Tc, basis_int)


def residual(Tv, Tv_prev):
    """||Tv - Tv_prev|| / ||Tv||, computed scale-invariantly.

    Tv holds cell *integrals* (ref: src/MacroscopicQuantities.cpp:130-157),
    which are ~1e-22 for micron-scale 3D cells — squaring underflows float32,
    so normalize by max|Tv| first (exact in the ratio)."""
    import jax.numpy as jnp

    scale = jnp.maximum(jnp.max(jnp.abs(Tv)), jnp.finfo(Tv.dtype).tiny)
    a = Tv / scale
    b = Tv_prev / scale
    return jnp.linalg.norm(a - b) / jnp.linalg.norm(a)
