"""Device-derived sizing (pbte.device) and the solver's memory policy."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbte import device
from pbte import mesh as pmesh
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat
from pbte.solver.source_iteration import SourceIterationSolver, _memory_limits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BCS3 = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}


def test_memory_budget_is_host_memory_on_cpu():
    budget = device.memory_budget()
    assert budget > 0
    assert budget == os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def test_memory_budget_raises_without_a_limit(monkeypatch):
    class Dev:
        platform = "gpu"
        device_kind = "test accelerator"

        def memory_stats(self):
            return None

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(RuntimeError, match="no memory limit"):
        device.memory_budget()


def test_memory_budget_reads_bytes_limit(monkeypatch):
    class Dev:
        platform = "gpu"
        device_kind = "test accelerator"

        def memory_stats(self):
            return {"bytes_limit": 60 * 2 ** 30, "bytes_in_use": 0}

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert device.memory_budget() == 60 * 2 ** 30


def test_memory_limits_equal_the_16gb_constants():
    """At a 16 GB budget every limit is the byte constant it replaces."""
    lim = _memory_limits(16e9)
    want = {
        "ring_state": 12e9,
        "general_ring_state": 4.5e9,
        "one_hot": 700e6,
        "one_hot_forced": 2e9,
        "auto_bf16_state": 11e9,
        "hoist_rhs": 2e9,
        "seq_groups": 6e9,
        "donate": 5.5e9,
    }
    assert set(lim) == set(want)
    for k, v in want.items():
        assert lim[k] == pytest.approx(v, rel=1e-12), k
    # and scale linearly with the budget
    lim80 = _memory_limits(80e9)
    for k in want:
        assert lim80[k] == pytest.approx(5 * lim[k], rel=1e-12), k


def _hex(nx=8, order=1, nspec=2):
    m = pmesh.make_cartesian_3d(nx, nx, nx, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=nspec)


def test_ring_choice_follows_the_budget(monkeypatch):
    """auto picks the lattice ring when its state fits the budget's share,
    and the compact scan when it does not."""
    ops, quad, tables = _hex()
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float32)
    assert s.sweep_mode == "ring"
    monkeypatch.setattr(device, "memory_budget", lambda: 1e5)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float32)
    assert s.sweep_mode == "scan"


def test_state_dtype_and_donation_follow_the_budget(monkeypatch):
    """An explicit ring that does not fit two f32 state buffers into the
    budget's share stores its state bf16 and donates it; with room it
    keeps f32 and does not donate."""
    ops, quad, tables = _hex()
    monkeypatch.setenv("PBTE_RING_WINDOWS", "0")
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float32,
                              sweep_mode="ring")
    assert s._ring_stage_bf16 and not s._ring_state_bf16
    assert not s._auto_mem and not s._donate_ring
    monkeypatch.setattr(device, "memory_budget", lambda: 1e5)
    s = SourceIterationSolver(ops, quad, tables, BCS3, dtype=jnp.float32,
                              sweep_mode="ring")
    assert s._ring_state_bf16 and s._auto_mem and s._donate_ring
    u, _, _ = s.initial_state()
    assert jax.tree_util.tree_leaves(u)[0].dtype == jnp.bfloat16


def test_compile_cache_dir_is_fixed_beside_the_package(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert device.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.chdir(REPO)
    assert device.compile_cache_dir() == str(tmp_path)


def test_measured_rates_are_positive():
    """The in-run peak measurements bench scripts scale by (tiny sizes)."""
    assert device.matmul_rate("float32", n=64, chain=2, reps=1) > 0
    assert device.copy_bandwidth(1, chain=2, reps=1) > 0
