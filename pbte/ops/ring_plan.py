"""Host-side one-hot selection plans for the general (non-lattice) ring sweep.

On lattice meshes the one-hot selection is superseded by static slab shifts
(solver/source_iteration.py, `_lattice_ring_tables`). What remains here is
the level-padded one-hot plan the general ring path consumes for
unstructured meshes (6-tet splits etc.), where upwind neighbors sit at
arbitrary slots of the previous H levels.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FusedSweepPlan:
    """Host-built, level-padded selection tensors for one direction group."""

    H: int  # ring depth (max upwind level gap)
    L: int
    W: int
    onehot: np.ndarray  # (nf, H*W, L, W) ring-slot -> neighbor map
    valid: np.ndarray  # (L, W) 1.0 real / 0.0 padding


def build_group_plan(nbr_pos, valid_pos, L, W, H) -> FusedSweepPlan:
    """Level-PADDED layout: position p holds (level p//W, slot p%W).
    nbr_pos (nf, L*W) with -1 boundary/padding; valid_pos (L*W,) bool."""
    nf, ne_pad = nbr_pos.shape
    onehot = np.zeros((nf, H * W, L, W), dtype=np.float32)
    valid = valid_pos.reshape(L, W).astype(np.float32)
    # vectorized over all (face, position) pairs (the per-position Python
    # loop was ~G*ne_pad*nf iterations of setup time)
    pos = np.arange(ne_pad)
    l, w = pos // W, pos % W
    nb = nbr_pos  # (nf, ne_pad)
    gl, gw = nb // W, nb % W
    gap = l[None, :] - gl
    # downwind (gap <= 0) neighbors never contribute (their inflow factor
    # cin is zero); invalid/boundary positions carry no entry
    use = (nb >= 0) & (gap > 0) & valid_pos[None, :]
    if np.any(use & (gap > H)):
        raise ValueError("upwind level gap exceeds ring depth")
    fi, pi = np.nonzero(use)
    onehot[fi, (gl[fi, pi] % H) * W + gw[fi, pi], l[pi], w[pi]] = 1.0
    return FusedSweepPlan(H=H, L=L, W=W, onehot=onehot, valid=valid)
