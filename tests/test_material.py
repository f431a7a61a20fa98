"""Phonon table parity vs the reference's committed golden dumps.

Golden sources:
- /root/reference/output/log/phonon_properties.txt (MFEM tree dump)
- /root/reference/reference/non_gray_smrt_params.txt (independent legacy dump)
"""

import numpy as np
import pytest

from pbte.material import nongray_smrt as mat


def _parse_phonon_properties(path):
    """Parse the golden phonon_properties.txt table."""
    rows = []
    heat_cap_v = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("HeatCapV:"):
                heat_cap_v = float(line.split(":")[1])
            parts = line.split()
            if len(parts) == 9 and parts[0] in ("0", "1"):
                rows.append([float(x) for x in parts])
    return np.array(rows), heat_cap_v


def test_tables_match_golden_dump(reference_root):
    golden, heat_cap_v = _parse_phonon_properties(
        reference_root / "output/log/phonon_properties.txt"
    )
    t = mat.build_tables(mat.SILICON, num_spectral=20)

    assert golden.shape == (40, 9)
    # Printed with %g (6 significant digits).
    for row in golden:
        b, s = int(row[0]), int(row[1])
        np.testing.assert_allclose(t.k[b, s], row[2], rtol=1e-5)
        np.testing.assert_allclose(t.omega[b, s], row[3], rtol=1e-5)
        np.testing.assert_allclose(t.dw[b, s], row[4], rtol=1e-5)
        np.testing.assert_allclose(t.vg[b, s], row[5], rtol=1e-5)
        np.testing.assert_allclose(t.inv_kn[b, s], row[6], rtol=1e-5)
        np.testing.assert_allclose(t.density[b, s], row[7], rtol=1e-5)
        np.testing.assert_allclose(t.heat_cap[b, s], row[8], rtol=1e-5)
    np.testing.assert_allclose(t.heat_cap_v, heat_cap_v, rtol=1e-5)


def test_heat_cap_v_matches_legacy_golden(reference_root):
    """Cross-check against the independent legacy params file
    (reference/non_gray_smrt_params.txt: HeatCapV 1.02243942e+18)."""
    text = (reference_root / "reference/non_gray_smrt_params.txt").read_text()
    legacy = None
    for line in text.splitlines():
        if "HeatCapV" in line:
            legacy = float(line.split()[-1])
    assert legacy is not None
    t = mat.build_tables(mat.SILICON, num_spectral=20)
    np.testing.assert_allclose(t.heat_cap_v, legacy, rtol=1e-8)


def test_material_yaml_loader(reference_root):
    loaded = mat.load_material(str(reference_root / "config/si.yaml"))
    assert loaded.C_LA == mat.SILICON.C_LA
    assert loaded.C_TA == mat.SILICON.C_TA
    assert loaded.lattice_dist == mat.SILICON.lattice_dist
    assert loaded.num_spectral == 20
    t1 = mat.build_tables(loaded)
    t2 = mat.build_tables(mat.SILICON)
    np.testing.assert_array_equal(t1.inv_kn, t2.inv_kn)


def test_ta_branch_umklapp_split():
    """The TA rate switches at k = k_max/2 (strict <)."""
    t = mat.build_tables(mat.SILICON, num_spectral=20)
    # bands 0..9 have k < k_max/2, bands 10..19 have k > k_max/2
    assert np.all(t.k[1, :10] < t.k_max / 2)
    assert np.all(t.k[1, 10:] > t.k_max / 2)
    # The golden table shows a discontinuity: invKn jumps down at band 10.
    assert t.inv_kn[1, 9] > 10 * t.inv_kn[1, 10]
