"""chip_smoke.py: refuses to run without a GPU, and its comparison helpers
hold at tiny sizes on the CPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_on_the_cpu_backend():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_ring_vs_oracle_helper_is_exact_at_tiny_size():
    """Phase b's comparison at hex 3^3: the f64 ring is iterate-exact."""
    err, mode, _, _ = chip_smoke.ring_vs_oracle(nx=3, nspec=2, steps=3)
    assert mode == "ring"
    assert err <= chip_smoke.TOL_EXACT


def test_slab_vs_lagged_oracle_helper_on_four_virtual_devices():
    """The --multi slab comparison on a (1, 4) virtual CPU mesh."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                axis_names=("dir", "space"))
    err, sl = chip_smoke.slab_vs_lagged_oracle(mesh, nx=4, steps=2)
    assert sl.P == 4
    assert err <= chip_smoke.TOL_EXACT


@pytest.mark.parametrize(
    "a, b, l2, mx",
    [([1.0, 2.0], [1.0, 2.0], 0.0, 0.0),
     ([1.0, 3.0], [1.0, 2.0], 1 / np.sqrt(5), 0.5)],
)
def test_relative_distances(a, b, l2, mx):
    assert chip_smoke.rel_l2(a, b) == pytest.approx(l2)
    assert chip_smoke.rel_max(a, b) == pytest.approx(mx)
