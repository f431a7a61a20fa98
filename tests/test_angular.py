"""Angular quadrature parity vs the reference's committed golden dumps.

Golden sources:
- /root/reference/output/log/angles_dim2_np24_gauss_na24_gauss.txt
- /root/reference/output/log/angles_dim3_np24_gauss_na24_gauss.txt
"""

import numpy as np
import pytest

from pbte.angular import quadrature as ang


def _parse_angles(path):
    rows = []
    with open(path) as f:
        in_table = False
        for line in f:
            if line.startswith("Directions"):
                in_table = True
                continue
            if in_table:
                parts = line.split()
                if len(parts) == 7:
                    rows.append([float(x) for x in parts])
    return np.array(rows)


@pytest.mark.parametrize("dim", [2, 3])
def test_golden_angles(reference_root, dim):
    golden = _parse_angles(
        reference_root / f"output/log/angles_dim{dim}_np24_gauss_na24_gauss.txt"
    )
    quad = ang.build(
        ang.AngularOptions(
            dimension=dim,
            polar_points=24,
            azimuth_points=24,
            polar_scheme="gauss",
            azimuth_scheme="gauss",
        )
    )
    expected_ndir = 24 if dim == 2 else 576
    assert quad.num_directions == expected_ndir
    assert golden.shape[0] == expected_ndir

    np.testing.assert_allclose(quad.polar, golden[:, 1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(quad.azimuth, golden[:, 2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(quad.weights, golden[:, 3], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(quad.directions, golden[:, 4:7], rtol=1e-4, atol=2e-6)

    expected_total = 2 * np.pi if dim == 2 else 4 * np.pi
    np.testing.assert_allclose(quad.total_weight, expected_total, rtol=1e-14)


def test_2d_single_polar_node():
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    assert len(quad.polar_nodes) == 1
    np.testing.assert_allclose(quad.polar, np.pi / 2)
    np.testing.assert_allclose(quad.directions[:, 2], 0.0)
    np.testing.assert_allclose(quad.total_weight, 2 * np.pi, rtol=1e-14)


def test_uniform_scheme_weights():
    quad = ang.build(
        ang.AngularOptions(dimension=3, polar_points=4, azimuth_points=8,
                           polar_scheme="uniform", azimuth_scheme="uniform")
    )
    # uniform midpoint: all weights equal after normalization
    np.testing.assert_allclose(quad.weights, 4 * np.pi / 32, rtol=1e-14)


def test_quadrature_integrates_moments():
    """Discrete ordinates should integrate low-order angular moments exactly:
    int s_i dOmega = 0, int s_i s_j dOmega = (4pi/3) delta_ij in 3D."""
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=8, azimuth_points=16))
    w = quad.weights
    s = quad.directions
    first = np.einsum("k,kd->d", w, s)
    np.testing.assert_allclose(first, 0.0, atol=1e-12)
    second = np.einsum("k,kd,ke->de", w, s, s)
    np.testing.assert_allclose(second, 4 * np.pi / 3 * np.eye(3), atol=1e-10)
