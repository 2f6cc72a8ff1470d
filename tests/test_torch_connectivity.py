"""The port's host mesh tables held bit-exact against the JAX package's:
every ``connectivity_csr(src, dst)`` pair (with ``edge_nodes`` and
``num_edges``) on a triangle rectangle, a hybrid quad/triangle mesh and a
tetrahedral box; ``structured_tet_box``; and ``refine`` of triangles and
tetrahedra, twice, with labelled boundaries (nodes, cells, faces and face
labels).  Both packages build from the same NumPy inputs."""

import dataclasses

import numpy as np
import pytest

from stormx.core.exceptions import StormError as JStormError
from stormx.mesh import build_hybrid_mesh as j_build_hybrid_mesh
from stormx.mesh import build_mesh as j_build_mesh
from stormx.mesh import refine as j_refine
from stormx.mesh import shapes as j_shapes
from stormx.mesh import structured_tet_box as j_tet_box
from stormx.mesh import structured_tri_rect as j_tri_rect
from stormx_torch.core.exceptions import StormError
from stormx_torch.mesh import build_hybrid_mesh, build_mesh, refine, structured_tet_box
from stormx_torch.mesh import structured_tri_rect

RANKS = ("node", "edge", "face", "cell")
PAIRS = [(s, d) for s in RANKS for d in RANKS]
MESH_FIELDS = [f.name for f in dataclasses.fields(j_tri_rect(1, 1))]


def _hybrid(build, shapes):
    xs = np.linspace(0, 2, 9)
    ys = np.linspace(0, 1, 5)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)
    quads, tris = [], []
    for i in range(8):
        for j in range(4):
            a, b, c, d = i * 5 + j, (i + 1) * 5 + j, (i + 1) * 5 + j + 1, i * 5 + j + 1
            if i < 4:
                quads.append([a, b, c, d])
            else:
                tris += [[a, b, c], [a, c, d]]
    return build(nodes, [(np.asarray(quads), shapes.QUADRANGLE),
                         (np.asarray(tris), shapes.TRIANGLE)])


MESHES = {
    "tri_rect": lambda: (structured_tri_rect(5, 4), j_tri_rect(5, 4)),
    "hybrid": lambda: (_hybrid(build_hybrid_mesh, j_shapes), _hybrid(j_build_hybrid_mesh, j_shapes)),
    "tet_box": lambda: (structured_tet_box(2, 3, 2), j_tet_box(2, 3, 2)),
}


def assert_mesh_equal(tm, jm):
    for name in MESH_FIELDS:
        a, b = getattr(tm, name), getattr(jm, name)
        if b is None or isinstance(b, (int, np.integer)):
            assert a == b, name
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    return MESHES[request.param]()


@pytest.mark.parametrize("src,dst", PAIRS)
def test_connectivity_csr_bit_exact(meshes, src, dst):
    tm, jm = meshes
    t_ptr, t_cols = tm.connectivity_csr(src, dst)
    j_ptr, j_cols = jm.connectivity_csr(src, dst)
    assert t_ptr.dtype == j_ptr.dtype and t_cols.dtype == j_cols.dtype
    np.testing.assert_array_equal(t_ptr, j_ptr)
    np.testing.assert_array_equal(t_cols, j_cols)


def test_edges_bit_exact(meshes):
    tm, jm = meshes
    np.testing.assert_array_equal(tm.edge_nodes(), jm.edge_nodes())
    assert tm.num_edges == jm.num_edges


def test_unknown_pair_raises(meshes):
    tm, jm = meshes
    with pytest.raises(StormError):
        tm.connectivity_csr("cell", "vertex")
    with pytest.raises(JStormError):
        jm.connectivity_csr("cell", "vertex")


@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 2, 4)])
def test_structured_tet_box_bit_exact(dims):
    assert_mesh_equal(structured_tet_box(*dims, lengths=(2.0, 1.0, 0.5)),
                      j_tet_box(*dims, lengths=(2.0, 1.0, 0.5)))


def _labelled(build, nodes, cells, face_nodes, labels):
    return build(nodes, cells, boundary_face_labels={
        tuple(sorted(int(v) for v in f)): int(lab) for f, lab in zip(face_nodes, labels)})


def _side_labels(mesh):
    """Boundary label per boundary face: 2 on x = 0, 3 on x = max, else 1."""
    b = mesh.boundary_faces()
    x = mesh.face_centers[b, 0]
    return mesh.face_nodes[b], np.where(x < 1e-12, 2, np.where(x > x.max() - 1e-12, 3, 1))


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_refine_twice_bit_exact_with_labels(kind):
    base = j_tri_rect(4, 3) if kind == "tri" else j_tet_box(2, 2, 1)
    fn, labels = _side_labels(base)
    tm = _labelled(build_mesh, base.node_positions, base.cell_nodes, fn, labels)
    jm = _labelled(j_build_mesh, base.node_positions, base.cell_nodes, fn, labels)
    assert_mesh_equal(tm, jm)
    assert tm.num_labels == 4
    for _ in range(2):
        tm, jm = refine(tm), j_refine(jm)
        assert_mesh_equal(tm, jm)
    # Children of a labelled boundary face keep its label.
    split = 4 if kind == "tri" else 16  # 2 or 4 children a round
    for lab in (1, 2, 3):
        assert len(tm.boundary_faces(lab)) == split * int((labels == lab).sum())


def test_refine_times_argument_and_refusal():
    m = structured_tri_rect(2, 2)
    assert_mesh_equal(refine(m, times=2), refine(refine(m)))
    quads = build_mesh(np.array([[0, 0], [1, 0], [1, 1], [0, 1.0]]), np.array([[0, 1, 2, 3]]))
    with pytest.raises(NotImplementedError):
        refine(quads)
