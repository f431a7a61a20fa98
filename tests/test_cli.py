"""End-to-end CLI tests: subprocess runs of the user-facing driver.

The CLI (pbte.cli) is the product surface mirroring the reference's
pbte_demo (src/PhononBTE.cpp); these tests catch arg-wiring regressions the
library-level golden tests cannot.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, cwd, n_devices=0, timeout=480):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    flags = [
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    if n_devices:
        flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    return subprocess.run(
        [sys.executable, "-m", "pbte.cli", "--platform", "cpu"] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.slow
def test_cli_demo_reproduces_goldens(tmp_path, reference_root):
    """The full demo run (reference config/config.yaml) from a scratch cwd
    must reproduce Tc_all.txt byte-identically and T_slice to 1e-12."""
    proc = _run_cli(
        ["-c", str(reference_root / "config/config.yaml"), "--out", "out"],
        cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    ours = (tmp_path / "out/log/Tc_all.txt").read_text().strip()
    gold = (reference_root / "output/log/Tc_all.txt").read_text().strip()
    assert ours == gold
    a = np.loadtxt(tmp_path / "out/2D/results/T_slice.txt", skiprows=2)
    b = np.loadtxt(reference_root / "output/2D/results/T_slice.txt", skiprows=2)
    np.testing.assert_allclose(a, b, atol=1e-12)
    # residual history file exists with one row per iteration
    hist = np.loadtxt(tmp_path / "out/2D/log/PBTE_NonGraySMRT_step_resisual.txt")
    assert hist.shape == (101, 2)
    assert (np.diff(hist[:, 0]) == 1).all()


@pytest.mark.slow
def test_cli_parallel_outputs_match_serial(tmp_path):
    """--parallel 2x2 on a 4-device virtual CPU mesh writes the same SET of
    dump files as the serial run (multi-rank-comparable outputs, the analog
    of src/Utils.cpp:100-148 rank gathering), including coeff_all and vtu —
    and the fields agree to the interface-lagging error scale (block-Jacobi
    lagged interfaces share only the fixed point with the serial
    Gauss-Seidel sweep — exact-at-convergence parity is covered by
    tests/test_parallel.py against the lagged oracle; this test guards the
    CLI plumbing: file set, formats, shapes, gathered values)."""
    base = ["-m", "unit-square-tri", "-o", "1", "--face-mode", "consistent",
            "--max-iter", "80", "--tol", "0", "--check-every", "20", "--vtu"]
    ser = _run_cli(base + ["--out", "ser"], cwd=tmp_path)
    assert ser.returncode == 0, ser.stderr[-2000:]
    par = _run_cli(base + ["--out", "par", "--parallel", "2x2"],
                   cwd=tmp_path, n_devices=4)
    assert par.returncode == 0, par.stderr[-2000:]
    for rel in ("log/Tc_all.txt", "log/coeff_all.txt",
                "2D/results/T_slice.txt"):
        a = (tmp_path / "ser" / rel).read_text()
        b = (tmp_path / "par" / rel).read_text()
        if a != b:
            na = np.array([float(x) for x in a.split() if _isfloat(x)])
            nb = np.array([float(x) for x in b.split() if _isfloat(x)])
            assert na.shape == nb.shape, rel
            # lagging noise is proportional to the field scale (Q entries
            # reach ~1e2); compare with a field-scaled absolute floor
            atol = max(5e-3, 0.05 * float(np.abs(na).max()))
            np.testing.assert_allclose(na, nb, rtol=0.1, atol=atol,
                                       err_msg=rel)
    # vis: the parallel run writes per-partition pieces + a .pvtu index (the
    # analog of the reference's per-rank ParGridFunction WriteParaView,
    # src/MacroscopicQuantities.cpp:168-271) instead of one gathered file.
    # Parity check: the UNION of the pieces' (point, T) rows must match the
    # serial vtu's rows (same DG nodal duplication, different element order).
    pvtu = (tmp_path / "par" / "vis" / "pbte_fields.pvtu").read_text()
    pieces = re.findall(r'Piece Source="([^"]+)"', pvtu)
    assert len(pieces) >= 2, pvtu
    ser_rows = _vtu_point_rows(tmp_path / "ser" / "vis" / "pbte_fields.vtu")
    par_rows = np.concatenate(
        [_vtu_point_rows(tmp_path / "par" / "vis" / p) for p in pieces])
    assert ser_rows.shape == par_rows.shape
    order = lambda r: np.lexsort(r.T[::-1])
    a, b = ser_rows[order(ser_rows)], par_rows[order(par_rows)]
    atol = max(5e-3, 0.05 * float(np.abs(a[:, 3]).max()))
    np.testing.assert_allclose(a, b, rtol=0.1, atol=atol,
                               err_msg="vtu piece union vs serial")


def _vtu_point_rows(path):
    """(npoints, 4) rows of (x, y, z, T) parsed from an ascii vtu."""
    text = path.read_text()
    def arr(section_re, ncomp):
        m = re.search(section_re + r"([^<]*)<", text)
        assert m, (section_re, path)
        vals = np.array([float(t) for t in m.group(1).split()])
        return vals.reshape(-1, ncomp)
    # the serial writer omits Name= on Points; match the enclosing section
    pts = arr(r"<Points>\s*<DataArray[^>]*>", 3)
    T = arr(r'<DataArray[^>]*Name="T"[^>]*>', 1)
    return np.concatenate([pts, T], axis=1)


def _isfloat(tok):
    try:
        float(tok)
        return True
    except ValueError:
        return False


@pytest.mark.slow
def test_cli_checkpoint_resume(tmp_path):
    """Interrupted run + --resume == uninterrupted run (bitwise on dumps)."""
    base = ["-m", "unit-square-tri", "-o", "1", "--face-mode", "consistent",
            "--tol", "0"]
    full = _run_cli(base + ["--max-iter", "10", "--out", "full"], cwd=tmp_path)
    assert full.returncode == 0, full.stderr[-2000:]
    ck = str(tmp_path / "ck.npz")
    first = _run_cli(
        base + ["--max-iter", "6", "--out", "p1", "--checkpoint", ck,
                "--checkpoint-every", "6"],
        cwd=tmp_path,
    )
    assert first.returncode == 0, first.stderr[-2000:]
    assert os.path.exists(ck)
    second = _run_cli(
        base + ["--max-iter", "4", "--out", "p2", "--checkpoint", ck,
                "--resume"],
        cwd=tmp_path,
    )
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from" in second.stdout
    a = (tmp_path / "full/log/Tc_all.txt").read_text()
    b = (tmp_path / "p2/log/Tc_all.txt").read_text()
    assert a == b


def test_cli_parallel_slab_lattice(tmp_path):
    """--parallel on a lattice (quad) mesh dispatches to SlabLatticeSolver
    and produces the same output-file set as the serial run; fields agree at
    the block-Jacobi lagging scale (exact-at-convergence parity is covered
    by tests/test_slab.py against the lagged oracle)."""
    base = ["-m", "unit-square-quad", "-o", "1", "--face-mode", "consistent",
            "--max-iter", "80", "--tol", "0", "--check-every", "20"]
    ser = _run_cli(base + ["--out", "ser"], cwd=tmp_path)
    assert ser.returncode == 0, ser.stderr[-2000:]
    par = _run_cli(base + ["--out", "par", "--parallel", "2x2"],
                   cwd=tmp_path, n_devices=4)
    assert par.returncode == 0, par.stderr[-2000:]
    assert "slab-lattice solver" in par.stderr + par.stdout, (
        par.stderr[-500:]
    )
    for rel in ("log/Tc_all.txt", "log/coeff_all.txt"):
        a = (tmp_path / "ser" / rel).read_text()
        b = (tmp_path / "par" / rel).read_text()
        if a != b:
            na = np.array([float(x) for x in a.split() if _isfloat(x)])
            nb = np.array([float(x) for x in b.split() if _isfloat(x)])
            assert na.shape == nb.shape, rel
            atol = max(5e-3, 0.05 * float(np.abs(na).max()))
            np.testing.assert_allclose(na, nb, rtol=0.1, atol=atol,
                                       err_msg=rel)


@pytest.mark.slow
def test_cli_3d_slices_in_reference_length_units(tmp_path):
    """--slice-z / --line-slice take coordinates in units of
    reference_length (the legacy z = 0.4*L_REF convention). Passing raw
    values used to sample metres-scale points far outside the micron-scale
    domain — every output value was NaN and nothing noticed."""
    proc = _run_cli(
        ["-m", "unit-cube-hex", "-o", "1", "--face-mode", "consistent",
         "--max-iter", "2", "--tol", "0",
         "--slice-z", "0.4", "--line-slice", "2", "0.5", "0.5"],
        cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    pl = np.loadtxt(tmp_path / "output/3D/results/T_slice_z.txt", skiprows=2)
    ln = np.loadtxt(tmp_path / "output/3D/results/T_line.txt", skiprows=1)
    assert pl.shape[1] == 6 and not np.isnan(pl).any()
    assert ln.shape[1] == 7 and not np.isnan(ln).any()
    # line runs along z at x = y = 0.5*L_REF (metres in the output file)
    assert np.allclose(ln[:, 0], 0.5e-6) and np.allclose(ln[:, 1], 0.5e-6)


@pytest.mark.slow
def test_cli_parallel_accelerate(tmp_path):
    """--accelerate composes with --parallel: the domain-decomposed solvers
    accept accelerate="bicgstab" (lagged halos are linear in the previous
    iterate), and at CONVERGENCE the block-Jacobi fixed point matches the
    serial one — so tight-tol accelerated runs must agree closely."""
    base = ["-m", "unit-square-tri", "-o", "1", "--face-mode", "consistent",
            "--tol", "1e-9", "--max-iter", "3000", "--check-every", "20",
            "--dtype", "f64", "--accelerate", "bicgstab"]
    ser = _run_cli(base + ["--out", "ser"], cwd=tmp_path)
    assert ser.returncode == 0, ser.stderr[-2000:]
    par = _run_cli(base + ["--out", "par", "--parallel", "2x2"],
                   cwd=tmp_path, n_devices=4)
    assert par.returncode == 0, par.stderr[-2000:]
    assert "bicgstab done" in par.stderr + par.stdout
    na = np.array([float(x) for x in
                   (tmp_path / "ser/log/Tc_all.txt").read_text().split()
                   if _isfloat(x)])
    nb = np.array([float(x) for x in
                   (tmp_path / "par/log/Tc_all.txt").read_text().split()
                   if _isfloat(x)])
    assert na.shape == nb.shape
    np.testing.assert_allclose(nb, na, rtol=0,
                               atol=1e-6 * float(np.abs(na).max()))


def test_cli_angle_override_flags(tmp_path):
    """-ad/-ap/-az/-aps/-aas override the config's angles block (ref
    README.md:56); the angles log name + direction count must reflect the
    override, and negative/empty values keep the config."""
    proc = _run_cli(
        ["-m", "unit-square-tri", "-o", "1", "--face-mode", "consistent",
         "--max-iter", "2", "--tol", "0",
         "-ad", "2", "-ap", "1", "-az", "8", "-aas", "uniform"],
        cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    log = tmp_path / "output/log/angles_dim2_np1_gauss_na8_uniform.txt"
    assert log.exists(), sorted(
        p.name for p in (tmp_path / "output/log").iterdir())
    assert "K=8" in proc.stdout or "K=8" in proc.stderr

    # -ad lifts a 2D config to full 3D solid angle on a 3D mesh
    proc3 = _run_cli(
        ["-m", "unit-cube-hex", "-o", "1", "--face-mode", "consistent",
         "--max-iter", "1", "--tol", "0",
         "-ad", "3", "-ap", "2", "-az", "4"],
        cwd=tmp_path,
    )
    assert proc3.returncode == 0, proc3.stderr[-2000:]
    assert (tmp_path / "output/log/angles_dim3_np2_gauss_na4_uniform.txt"
            ).exists() or (
        tmp_path / "output/log/angles_dim3_np2_gauss_na4_gauss.txt").exists()


def test_validation_entry_point(tmp_path):
    """`python -m pbte.validation N` is the operational analog of the
    reference's TestMeshPartition binary (exit code 0 = all 7 invariant
    checks pass, 1 = failure; TestMeshPartition.cpp:126-164)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "pbte.validation", "4",
         "--mesh", "unit-cube-tet", "--refine", "1",
         "--method", "multilevel"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all validations passed" in proc.stdout
    assert "load balance" in proc.stdout

    # invalid partition count -> nonzero exit, like the reference runner
    bad = subprocess.run(
        [sys.executable, "-m", "pbte.validation", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60,
    )
    assert bad.returncode == 1
