#!/usr/bin/env python
"""Contour plot of a sampled temperature slice.

Equivalent of the reference's scripts/plot2d_contour.py (parses the
`# nx N ny N` header written by pbte.io.slice.write_2d_slice and renders
a filled contour). Usage:

    python scripts/plot2d_contour.py output/2D/results/T_slice.txt [out.png]
"""

from __future__ import annotations

import sys

import numpy as np


def read_slice(path):
    with open(path) as f:
        header = f.readline().split()
        nx, ny = int(header[2]), int(header[4])
        f.readline()  # column header
        data = np.loadtxt(f)
    x = data[:, 0].reshape(ny, nx)
    y = data[:, 1].reshape(ny, nx)
    T = data[:, 2].reshape(ny, nx)
    return x, y, T


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    path = argv[1]
    out = argv[2] if len(argv) > 2 else "T_slice.png"
    x, y, T = read_slice(path)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; slice stats only:")
        print(f"  nx={x.shape[1]} ny={x.shape[0]} "
              f"T in [{np.nanmin(T):.4g}, {np.nanmax(T):.4g}]")
        return 0
    fig, ax = plt.subplots(figsize=(6, 5))
    cs = ax.contourf(x, y, T, levels=24, cmap="inferno")
    fig.colorbar(cs, ax=ax, label="T deviation [K]")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
