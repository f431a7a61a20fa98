#!/usr/bin/env python
"""Plot 3D slice outputs: z-plane contours and 1D line profiles.

Framework counterpart of the reference's postprocessing notebook
(ref: reference/plot3D.ipynb), as plot2d_contour.py is for the 2D slice
script. Reads the text artifacts written by pbte.io.slice:

- plane slices (write_3d_slice): header ``# nx N ny N z Z`` then columns
  ``x y T Qx Qy Qz``  ->  filled contour of T (optionally a Q-magnitude
  quiver overlay with --quiver).
- line slices (write_3d_line_slice): header comment then columns
  ``x y z T Qx Qy Qz``  ->  T profile along the varying axis; several
  files overlay on one axes (the notebook's multi-L comparison), each
  normalized by its own length scale via repeated --length.

Usage:
  python scripts/plot3d_slice.py plane out/T_slice3d.txt -o slice.png
  python scripts/plot3d_slice.py line a.txt b.txt --length 1e-6 1e-7 -o T.png
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np


def _read_header_dims(path):
    with open(path) as f:
        first = f.readline()
    m = re.match(r"#\s*nx\s+(\d+)\s+ny\s+(\d+)", first)
    if not m:
        raise SystemExit(f"{path}: missing '# nx N ny N' plane-slice header")
    return int(m.group(1)), int(m.group(2))


def plot_plane(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = args.files[0]
    nx, ny = _read_header_dims(path)
    data = np.loadtxt(path, skiprows=2)
    if data.shape[0] != nx * ny:
        raise SystemExit(f"{path}: expected {nx * ny} rows, got {data.shape[0]}")
    # rows are written x-major within each y line (j outer, i inner)
    X = data[:, 0].reshape(ny, nx)
    Y = data[:, 1].reshape(ny, nx)
    T = data[:, 2].reshape(ny, nx)
    fig, ax = plt.subplots(figsize=(6.4, 5.6))
    levels = np.linspace(T.min(), T.max(), args.levels) if T.max() > T.min() \
        else args.levels
    c = ax.contourf(X, Y, T, levels, cmap=args.cmap)
    fig.colorbar(c, ax=ax, label="T (deviation from T_ref)")
    if args.quiver and data.shape[1] >= 6:
        s = max(1, nx // 20)
        ax.quiver(X[::s, ::s], Y[::s, ::s],
                  data[:, 3].reshape(ny, nx)[::s, ::s],
                  data[:, 4].reshape(ny, nx)[::s, ::s],
                  color="white", width=2e-3)
    ax.set_aspect("equal")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.tight_layout()
    fig.savefig(args.output, dpi=args.dpi)
    print(f"wrote {args.output} ({nx}x{ny}, T in [{T.min():.4g}, {T.max():.4g}])")


def plot_line(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lengths = args.length or [1.0] * len(args.files)
    if len(lengths) == 1:
        lengths = lengths * len(args.files)
    if len(lengths) != len(args.files):
        raise SystemExit("--length count must be 1 or match the file count")
    fig, ax = plt.subplots(figsize=(7.2, 5.0))
    for path, L in zip(args.files, lengths):
        data = np.loadtxt(path, skiprows=2)
        xyz, T = data[:, :3], data[:, 3] + args.offset
        # the varying axis is the one with non-constant coordinates
        axis = int(np.argmax(np.ptp(xyz, axis=0)))
        s = xyz[:, axis] / L
        label = f"{path}" if L == 1.0 else f"L = {L:g}"
        ax.plot(s, T, "*-", markersize=2.5, linewidth=1, label=label)
    ax.set_xlabel("xyz"[axis] + (" / L" if args.length else ""))
    ax.set_ylabel("T")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.output, dpi=args.dpi)
    print(f"wrote {args.output} ({len(args.files)} profile(s))")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("plane", "line"))
    p.add_argument("files", nargs="+", help="slice text file(s)")
    p.add_argument("-o", "--output", default="slice3d.png")
    p.add_argument("--levels", type=int, default=21)
    p.add_argument("--cmap", default="plasma")
    p.add_argument("--quiver", action="store_true",
                   help="overlay heat-flux vectors on a plane slice")
    p.add_argument("--length", type=float, nargs="*", default=None,
                   help="per-file length scale to normalize the line axis by")
    p.add_argument("--offset", type=float, default=0.0,
                   help="additive T offset (e.g. 0.5 to undo the -0.5 wall)")
    p.add_argument("--dpi", type=int, default=150)
    args = p.parse_args(argv)
    if args.mode == "plane":
        plot_plane(args)
    else:
        plot_line(args)


if __name__ == "__main__":
    sys.exit(main())
