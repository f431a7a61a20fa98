"""Test configuration: JAX on the CPU with 8 virtual devices and float64.

Multi-device tests use the virtual CPU mesh — the JAX analog of the reference's
single-machine `mpirun -np N` smoke tests (SURVEY.md section 4). The
environment is set before the first jax import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_ENABLE_X64"] = "1"

import pathlib

import pytest

REFERENCE_ROOT = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE_ROOT.exists():
        pytest.skip("reference tree not available")
    return REFERENCE_ROOT
