"""Postprocessing script tests (scripts/plot2d_contour.py, plot3d_slice.py).

The viz scripts are the framework's counterpart of the reference's
postprocessing layer (ref: scripts/plot2d_contour.py, reference/plot3D.ipynb).
These tests drive them end-to-end on synthetic slice files in the exact
formats pbte.io.slice writes, so a format drift in either side breaks
here instead of at paper time.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytest.importorskip("matplotlib")


def _run(args, cwd):
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, capture_output=True, text=True,
        timeout=120,
    )


def _write_plane_slice(path, nx=12, ny=10, with_z=True, ncols=6):
    with open(path, "w") as f:
        hdr = f"# nx {nx} ny {ny}"
        if with_z:
            hdr += " z 0.4"
        f.write(hdr + "\n")
        f.write("x y T Qx Qy Qz\n" if ncols == 6 else "x y T\n")
        for j in range(ny):
            for i in range(nx):
                x, y = i / (nx - 1), j / (ny - 1)
                row = [x, y, np.sin(3 * x) * y]
                if ncols == 6:
                    row += [x, -y, 0.0]
                f.write(" ".join(f"{v:.16f}" for v in row) + "\n")


def test_plot2d_contour(tmp_path):
    p = tmp_path / "T_slice.txt"
    _write_plane_slice(p, with_z=False, ncols=3)
    out = tmp_path / "c.png"
    r = _run([os.path.join(REPO, "scripts", "plot2d_contour.py"),
              str(p), str(out)], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert out.exists() and out.stat().st_size > 1000


def test_plot3d_plane(tmp_path):
    p = tmp_path / "T_slice3d.txt"
    _write_plane_slice(p)
    out = tmp_path / "p.png"
    r = _run([os.path.join(REPO, "scripts", "plot3d_slice.py"), "plane",
              str(p), "--quiver", "-o", str(out)], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert out.exists() and out.stat().st_size > 1000


def test_plot3d_line_multifile(tmp_path):
    paths = []
    for fi, L in enumerate((1e-6, 1e-7)):
        p = tmp_path / f"line{fi}.txt"
        with open(p, "w") as f:
            f.write("# line slice\n")
            f.write("x y z T Qx Qy Qz\n")
            for j in range(20):
                f.write(f"0.5 {j / 19 * L:.16e} 0.5 {j / 19 - 0.5:.16f} "
                        "0 0 0\n")
        paths.append(str(p))
    out = tmp_path / "l.png"
    r = _run([os.path.join(REPO, "scripts", "plot3d_slice.py"), "line",
              *paths, "--length", "1e-6", "1e-7", "--offset", "0.5",
              "-o", str(out)], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert out.exists() and out.stat().st_size > 1000


def test_plot3d_rejects_bad_header(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("no header\n0 0 0\n")
    r = _run([os.path.join(REPO, "scripts", "plot3d_slice.py"), "plane",
              str(p)], cwd=tmp_path)
    assert r.returncode != 0
