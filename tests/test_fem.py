"""FEM assembly parity vs the reference golden integral dump.

Golden source: /root/reference/output/log/integrals_all.txt — every volume and
face integral tensor for the 2-element unit-square-iso mesh at p=1, scaled by
reference_length=1e-6 (printed with %g, so compare at rtol 1e-5).
"""

import re

import numpy as np
import pytest

from pbte import mesh as pmesh
from pbte.fem import assembly, reference as fref


def _parse_integrals(path):
    """Parse integrals_all.txt into per-element dicts."""
    elems = []
    cur = None
    lines = open(path).read().splitlines()
    i = 0

    def floats(s):
        return [float(x) for x in s.split()]

    while i < len(lines):
        ln = lines[i].strip()
        if ln.startswith("=== Element"):
            cur = {"face_mass": [], "face_int": [], "couplings": []}
            elems.append(cur)
        elif ln.startswith("basis_integrals"):
            cur["basis_int"] = floats(ln.split(":", 1)[1])
        elif ln.startswith("mass_matrix"):
            n = int(re.search(r"shape=(\d+)x", ln).group(1))
            cur["mass"] = np.array([floats(lines[i + 1 + r]) for r in range(n)])
            i += n
        elif ln.startswith("stiffness_matrix_dim"):
            d = int(re.search(r"dim(\d+)", ln).group(1))
            n = int(re.search(r"shape=(\d+)x", ln).group(1))
            cur.setdefault("stiff", {})[d] = np.array(
                [floats(lines[i + 1 + r]) for r in range(n)]
            )
            i += n
        elif ln.startswith("face_mass_matrix["):
            n = int(re.search(r"shape=(\d+)x", ln).group(1))
            cur["face_mass"].append(
                np.array([floats(lines[i + 1 + r]) for r in range(n)])
            )
            i += n
        elif ln.startswith("face_integral["):
            cur["face_int"].append(floats(ln.split(":", 1)[1]))
        elif ln.startswith("face_coupling["):
            m = re.search(r"face_id=(\d+), neighbor=(-?\d+), attr=(\d+)", ln)
            fc = {
                "face_id": int(m.group(1)),
                "neighbor": int(m.group(2)),
                "attr": int(m.group(3)),
            }
            nxt = lines[i + 1].strip()
            if nxt.startswith("coupling"):
                n = int(re.search(r"shape=(\d+)x", nxt).group(1))
                fc["coupling"] = np.array(
                    [floats(lines[i + 2 + r]) for r in range(n)]
                )
                i += 1 + n
            elif nxt.startswith("isothermal_rhs"):
                fc["isothermal_rhs"] = floats(nxt.split(":", 1)[1])
                i += 1
            cur["couplings"].append(fc)
        i += 1
    return elems


@pytest.fixture(scope="module")
def ops2d(reference_root):
    m = pmesh.load_mfem_mesh(str(reference_root / "config/mesh/unit-square-iso.mesh"))
    topo = pmesh.connect(m.scaled(1.0e-6))
    return assembly.assemble(topo, order=1)  # default face_mode="mfem-parity"


def test_integrals_match_golden(reference_root, ops2d):
    golden = _parse_integrals(reference_root / "output/log/integrals_all.txt")
    assert len(golden) == 2
    rtol = 1e-5
    for e, g in enumerate(golden):
        np.testing.assert_allclose(ops2d.basis_int[e], g["basis_int"], rtol=rtol)
        np.testing.assert_allclose(ops2d.mass[e], g["mass"], rtol=rtol, atol=1e-19)
        for d in (0, 1):
            np.testing.assert_allclose(
                ops2d.stiff[e, d], g["stiff"][d], rtol=rtol, atol=1e-12
            )
        assert len(g["face_mass"]) == 3
        for f in range(3):
            np.testing.assert_allclose(
                ops2d.face_mass[e, f], g["face_mass"][f], rtol=rtol, atol=1e-12
            )
            np.testing.assert_allclose(
                ops2d.face_int[e, f], g["face_int"][f], rtol=rtol, atol=1e-12
            )
        for f, fc in enumerate(g["couplings"]):
            assert ops2d.elem_face[e, f] == fc["face_id"]
            assert ops2d.neighbor[e, f] == fc["neighbor"]
            assert ops2d.face_attr[e, f] == fc["attr"]
            if "coupling" in fc:
                np.testing.assert_allclose(
                    ops2d.coupling[e, f], fc["coupling"], rtol=rtol, atol=1e-12
                )
            else:
                np.testing.assert_allclose(
                    ops2d.face_int[e, f], fc["isothermal_rhs"], rtol=rtol, atol=1e-12
                )


def test_basis_partition_of_unity():
    for geom, p in [("triangle", 1), ("triangle", 3), ("quad", 2), ("tet", 2), ("hex", 1)]:
        b = fref.basis(geom, p)
        rng = np.random.default_rng(0)
        pts = rng.uniform(0.1, 0.3, size=(20, b.nodes.shape[1]))
        np.testing.assert_allclose(b.eval(pts).sum(-1), 1.0, atol=1e-11)
        np.testing.assert_allclose(b.eval_grad(pts).sum(-2), 0.0, atol=1e-9)
        # Kronecker property at the nodes
        np.testing.assert_allclose(b.eval(b.nodes), np.eye(b.ndof), atol=1e-10)


@pytest.mark.parametrize(
    "maker,p",
    [
        (lambda: pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_TRIANGLE), 2),
        (lambda: pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_QUAD), 2),
        (lambda: pmesh.make_cartesian_3d(1, 1, 1, pmesh.GEOM_TET), 1),
        (lambda: pmesh.make_cartesian_3d(1, 1, 1, pmesh.GEOM_HEX), 2),
    ],
)
def test_assembly_identities(maker, p):
    """Exactness identities that hold for any correct DG assembly:
    - sum_i basis_int = total element measure,
    - mass symmetric positive definite,
    - row sums of stiffness = int d_d(1)*p_j = 0 ... actually column identity:
      sum_i stiff[d][i][j] = int d_d(sum_i p_i) p_j = 0 (partition of unity),
    - divergence identity: stiff[d] + stiff[d]^T = sum_faces n_d * face_mass
      (integration by parts with p_i p_j)."""
    m = maker()
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=p, face_mode="consistent")

    vol = ops.basis_int.sum()
    np.testing.assert_allclose(vol, 1.0, rtol=1e-12)  # unit square/cube

    for e in range(ops.num_elements):
        np.testing.assert_allclose(ops.mass[e], ops.mass[e].T, atol=1e-16)
        assert np.all(np.linalg.eigvalsh(ops.mass[e]) > 0)
        np.testing.assert_allclose(ops.stiff[e].sum(axis=1), 0.0, atol=1e-13)
        for d in range(ops.dim):
            surf = np.einsum("f,fij->ij", ops.normals[e, :, d], ops.face_mass[e])
            np.testing.assert_allclose(
                ops.stiff[e, d] + ops.stiff[e, d].T, surf, atol=1e-13
            )


def test_coupling_consistency():
    """coupling[e,f] must equal coupling[nbr,f']^T across each interior face."""
    m = pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_TRIANGLE)
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=2, face_mode="consistent")
    for e in range(ops.num_elements):
        for f in range(ops.faces_per_elem):
            nbr = ops.neighbor[e, f]
            if nbr < 0:
                continue
            fid = topo.elem_face[e, f]
            f2 = int(np.where(topo.elem_face[nbr] == fid)[0][0])
            np.testing.assert_allclose(
                ops.coupling[e, f], ops.coupling[nbr, f2].T, atol=1e-16
            )


@pytest.mark.parametrize("geom,make,order", [
    ("triangle", lambda: pmesh.make_cartesian_2d(3, 2, "triangle"), 1),
    ("triangle", lambda: pmesh.make_cartesian_2d(3, 2, "triangle"), 3),
    ("tet", lambda: pmesh.make_cartesian_3d(2, 2, 2, "tet"), 2),
])
def test_exact_volume_operators_match_quadrature(geom, make, order):
    """Closed-form monomial integrals (fem.exact, the analog of the
    reference's math_utils.cpp:76-159 backend) must agree with the 2p+1
    quadrature to machine precision on affine simplices."""
    m = make()
    topo = pmesh.connect(m)
    a_q = assembly.assemble(topo, order=order, face_mode="consistent")
    a_e = assembly.assemble(topo, order=order, face_mode="consistent",
                            volume_mode="exact")
    np.testing.assert_allclose(a_e.basis_int, a_q.basis_int,
                               rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(a_e.mass, a_q.mass, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(a_e.stiff, a_q.stiff, rtol=1e-11, atol=1e-13)


def test_exact_monomial_integrals_values():
    """Spot values: int over unit triangle of 1, x, x*y, x^2."""
    from pbte.fem.exact import monomial_integrals_simplex

    expo = np.array([[0, 0], [1, 0], [1, 1], [2, 0]])
    got = monomial_integrals_simplex(expo, 2)
    np.testing.assert_allclose(got, [0.5, 1 / 6, 1 / 24, 1 / 12], rtol=1e-15)


def test_element_classes_noise_merge_p3():
    """p=3 face-trace Newton noise (~4e-12 relative) straddles the fine
    1e-11 class-hash quanta and split a translation-invariant hex mesh
    into hundreds of bogus classes (disabling the ring sweep at p=3 and
    exploding the class-factor build). The representative merge pass must
    collapse them to 1 — while genuinely different elements (a stretched
    lattice with two element sizes) must stay separate."""
    from pbte import mesh as pmesh

    m = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    ops = assembly.assemble(pmesh.connect(m), order=3,
                            face_mode="consistent")
    ops_c = assembly.permute_faces(ops, assembly.canonical_face_perm(ops))
    cls = assembly.element_classes(ops_c)
    assert int(cls.max()) + 1 == 1

    # two genuinely different element sizes: never merged
    import numpy as np

    m2 = pmesh.make_cartesian_3d(4, 4, 4, "hex").scaled(1e-6)
    v = m2.vertices.copy()
    # stretch the top half of the z axis: elements there are taller
    hi = v[:, 2] > 0.5e-6
    v[hi, 2] = 0.5e-6 + (v[hi, 2] - 0.5e-6) * 1.25
    m2 = pmesh.MeshData(**{**m2.__dict__, "vertices": v})
    ops2 = assembly.assemble(pmesh.connect(m2), order=1,
                             face_mode="consistent")
    ops2c = assembly.permute_faces(ops2,
                                   assembly.canonical_face_perm(ops2))
    cls2 = assembly.element_classes(ops2c)
    assert int(cls2.max()) + 1 >= 2
