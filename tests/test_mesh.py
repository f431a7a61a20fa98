"""Mesh layer parity vs the reference golden mesh summaries.

Golden source: /root/reference/output/log/mesh_unit-square-iso_p1_dim2.txt
(2-element triangle mesh, coordinates scaled by reference_length=1e-6).
"""

import numpy as np
import pytest

from pbte import mesh as pmesh


@pytest.fixture
def iso2d(reference_root):
    m = pmesh.load_mfem_mesh(str(reference_root / "config/mesh/unit-square-iso.mesh"))
    return m.scaled(1.0e-6)


def test_triangle_rotation_matches_mfem(iso2d):
    # Golden summary: elem 0 = (v2, v0, v1), elem 1 = (v0, v2, v3).
    np.testing.assert_array_equal(iso2d.elem_verts[0], [2, 0, 1])
    np.testing.assert_array_equal(iso2d.elem_verts[1], [0, 2, 3])


def test_connectivity_matches_golden_summary(iso2d):
    topo = pmesh.connect(iso2d)
    # Golden: elem 0 faces 0,1,2 (0 interior neigh=1; 1,2 boundary attr 1)
    #         elem 1 faces 0,3,4 (0 interior neigh=0; 3 attr 2; 4 attr 1)
    np.testing.assert_array_equal(topo.elem_face[0], [0, 1, 2])
    np.testing.assert_array_equal(topo.elem_face[1], [0, 3, 4])
    np.testing.assert_array_equal(topo.elem_neighbor[0], [1, -1, -1])
    np.testing.assert_array_equal(topo.elem_neighbor[1], [0, -1, -1])
    np.testing.assert_array_equal(topo.elem_face_attr[0], [0, 1, 1])
    np.testing.assert_array_equal(topo.elem_face_attr[1], [0, 2, 1])


def test_outward_normals(iso2d):
    topo = pmesh.connect(iso2d)
    # Unit normals; elem 0 = lower-right triangle (v2,v0,v1) = (1,1),(0,0),(1,0),
    # centroid (2/3,1/3). Face 0 is the diagonal (2,0): elem 0's outward normal
    # points up-left, (-1,1)/sqrt(2); elem 1's points down-right.
    s2 = 1 / np.sqrt(2)
    np.testing.assert_allclose(topo.normals[0, 0], [-s2, s2], atol=1e-14)
    np.testing.assert_allclose(topo.normals[1, 0], [s2, -s2], atol=1e-14)
    # boundary faces of elem 0: bottom (0,-1) and right (1,0)
    np.testing.assert_allclose(np.sort(topo.normals[0, 1:], axis=0),
                               [[0.0, -1.0], [1.0, 0.0]], atol=1e-14)
    # all normals unit length
    np.testing.assert_allclose(np.linalg.norm(topo.normals, axis=-1), 1.0, atol=1e-14)


def test_normals_antisymmetric_across_interior_faces():
    m = pmesh.make_cartesian_2d(4, 3, pmesh.GEOM_TRIANGLE)
    topo = pmesh.connect(m)
    for e in range(m.num_elements):
        for lf in range(3):
            nbr = topo.elem_neighbor[e, lf]
            if nbr < 0:
                continue
            fid = topo.elem_face[e, lf]
            lf_nbr = int(np.where(topo.elem_face[nbr] == fid)[0][0])
            np.testing.assert_allclose(
                topo.normals[e, lf], -topo.normals[nbr, lf_nbr], atol=1e-13
            )


@pytest.mark.parametrize(
    "maker,geom,expect_ne",
    [
        (lambda: pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_TRIANGLE), "tri", 8),
        (lambda: pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_QUAD), "quad", 4),
        (lambda: pmesh.make_cartesian_3d(1, 1, 1, pmesh.GEOM_TET), "tet", 6),
        (lambda: pmesh.make_cartesian_3d(2, 1, 1, pmesh.GEOM_HEX), "hex", 2),
    ],
)
def test_builtin_volume_and_closure(maker, geom, expect_ne):
    """Generated meshes: correct count, positive measures, watertight boundary."""
    m = maker()
    assert m.num_elements == expect_ne
    topo = pmesh.connect(m)
    # every interior face shared by exactly 2 elements; boundary faces have attr>0
    interior = topo.face_elems[:, 1] >= 0
    assert np.all(topo.face_attr[interior] == 0)
    assert np.all(topo.face_attr[~interior] > 0)
    # boundary element count matches number of boundary faces
    assert (~interior).sum() == len(m.bdry_verts)


def test_six_tet_split_matches_committed_mesh(reference_root):
    """Same 6-tet decomposition as the committed unit-cube-tet-iso.mesh
    (vertex *numbering* differs: the committed file numbers the cube corners
    counterclockwise, the generator lexicographically)."""
    ref = pmesh.load_mfem_mesh(str(reference_root / "config/mesh/unit-cube-tet-iso.mesh"))
    ours = pmesh.make_cartesian_3d(1, 1, 1, pmesh.GEOM_TET)
    assert ref.num_elements == ours.num_elements == 6

    def tet_set(m):
        return {
            frozenset(tuple(m.vertices[v]) for v in tet) for tet in m.elem_verts
        }

    assert tet_set(ref) == tet_set(ours)


@pytest.mark.parametrize(
    "m",
    [
        pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_TRIANGLE),
        pmesh.make_cartesian_2d(2, 2, pmesh.GEOM_QUAD),
        pmesh.make_cartesian_3d(1, 1, 1, pmesh.GEOM_TET),
        pmesh.make_cartesian_3d(1, 1, 1, pmesh.GEOM_HEX),
    ],
)
def test_uniform_refine_preserves_volume_and_boundary(m):
    nchild = {"triangle": 4, "quad": 4, "tet": 8, "hex": 8}[m.geom]
    r = pmesh.uniform_refine(m)
    assert r.num_elements == nchild * m.num_elements

    def total_volume(mm):
        topo = pmesh.connect(mm)
        v = mm.vertices[mm.elem_verts]
        def cross2(a, b):
            return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]

        if mm.geom == "triangle":
            return np.abs(cross2(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]) / 2).sum()
        if mm.geom == "quad":
            return np.abs(
                cross2(v[:, 1] - v[:, 0], v[:, 3] - v[:, 0])
            ).sum()  # parallelograms only (Cartesian)
        if mm.geom == "tet":
            return np.abs(
                np.einsum(
                    "ei,ei->e",
                    np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
                    v[:, 3] - v[:, 0],
                )
                / 6
            ).sum()
        if mm.geom == "hex":
            return np.abs(
                np.einsum(
                    "ei,ei->e",
                    np.cross(v[:, 1] - v[:, 0], v[:, 3] - v[:, 0]),
                    v[:, 4] - v[:, 0],
                )
            ).sum()  # Cartesian hexes

    np.testing.assert_allclose(total_volume(r), total_volume(m), rtol=1e-12)
    # boundary splits into (2 in 2D, 4 in 3D) children per boundary face
    factor = 2 if m.dim == 2 else 4
    assert len(r.bdry_verts) == factor * len(m.bdry_verts)
    # all refined boundary faces still carry attributes
    topo = pmesh.connect(r)
    interior = topo.face_elems[:, 1] >= 0
    assert np.all(topo.face_attr[~interior] > 0)


def test_summary_golden_format(iso2d, reference_root, tmp_path):
    from pbte.mesh.summary import make_summary

    topo = pmesh.connect(iso2d)
    # p=1 triangle: 3 dofs/elem, 2 elems -> 6 ndofs
    text = make_summary(topo, order=1, ndofs=6)
    golden = (reference_root / "output/log/mesh_unit-square-iso_p1_dim2.txt").read_text()

    def body(t):
        # skip the mesh-source line (paths differ)
        return [ln for ln in t.strip().splitlines() if "mesh source" not in ln]

    assert body(text) == body(golden)


def test_mfem_roundtrip(iso2d, tmp_path):
    p = tmp_path / "rt.mesh"
    pmesh.write_mfem_mesh(iso2d, str(p))
    again = pmesh.load_mfem_mesh(str(p))
    np.testing.assert_array_equal(again.elem_verts, iso2d.elem_verts)
    np.testing.assert_allclose(again.vertices, iso2d.vertices)
    np.testing.assert_array_equal(again.bdry_attr, iso2d.bdry_attr)


def _connect_dict_scan(mesh):
    """The naive per-element dict scan connect() replaced (kept as the
    semantics oracle: faces numbered first-seen, first-occurrence vertex
    orientation, later boundary entries override)."""
    from pbte.mesh.core import LOCAL_FACES

    local_faces = LOCAL_FACES[mesh.geom]
    nf = len(local_faces)
    ne = mesh.num_elements
    face_index = {}
    face_verts_list, face_elems_list = [], []
    elem_face = np.full((ne, nf), -1, dtype=np.int32)
    ev = mesh.elem_verts
    for e in range(ne):
        for lf, loc in enumerate(local_faces):
            fverts = tuple(int(ev[e, i]) for i in loc)
            key = tuple(sorted(fverts))
            fid = face_index.get(key)
            if fid is None:
                fid = len(face_verts_list)
                face_index[key] = fid
                face_verts_list.append(fverts)
                face_elems_list.append([e, -1])
            else:
                face_elems_list[fid][1] = e
            elem_face[e, lf] = fid
    face_attr = np.zeros(len(face_verts_list), dtype=np.int32)
    for bv, battr in zip(mesh.bdry_verts, mesh.bdry_attr):
        fid = face_index.get(tuple(sorted(int(x) for x in bv)))
        if fid is not None:
            face_attr[fid] = battr
    return (np.asarray(face_verts_list, dtype=np.int32),
            np.asarray(face_elems_list, dtype=np.int32), face_attr, elem_face)


@pytest.mark.parametrize(
    "make",
    [
        lambda: pmesh.make_cartesian_2d(5, 4, pmesh.GEOM_TRIANGLE),
        lambda: pmesh.make_cartesian_2d(4, 6, pmesh.GEOM_QUAD),
        lambda: pmesh.make_cartesian_3d(3, 2, 4, pmesh.GEOM_TET),
        lambda: pmesh.make_cartesian_3d(3, 3, 2, pmesh.GEOM_HEX),
    ],
)
def test_connect_matches_dict_scan(make):
    """Vectorized sort-based connect() must reproduce the sequential dict
    scan exactly: same face numbering, orientation, pairing, attributes."""
    m = make()
    topo = pmesh.connect(m)
    fv, fe, fa, ef = _connect_dict_scan(m)
    np.testing.assert_array_equal(topo.face_verts, fv)
    np.testing.assert_array_equal(topo.face_elems, fe)
    np.testing.assert_array_equal(topo.face_attr, fa)
    order = np.argsort(ef, axis=1)
    np.testing.assert_array_equal(topo.elem_face, np.take_along_axis(ef, order, axis=1))


def test_connect_scales():
    """Setup budget: connect() on a ~1e5-element mesh in seconds, not
    minutes."""
    import time

    m = pmesh.make_cartesian_3d(26, 26, 26, pmesh.GEOM_TET)  # 105k tets
    t0 = time.time()
    topo = pmesh.connect(m)
    dt = time.time() - t0
    assert topo.mesh.num_elements == 26 * 26 * 26 * 6
    interior = (topo.face_elems[:, 1] >= 0).sum()
    assert interior > 0 and (topo.elem_neighbor >= 0).sum() == 2 * interior
    assert dt < 30.0, f"connect took {dt:.1f}s at ne=105k"
