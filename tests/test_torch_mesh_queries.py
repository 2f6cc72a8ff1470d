"""``UnstructuredMesh.find_face``, ``find_cell``, ``assign_face_labels`` and
``num_faces_with_label`` of stormx_torch against the JAX package's
(``tests/test_mesh.py:359-400``'s cases and a larger mesh): host-side NumPy,
bit-exact; the relabeled mesh's device arrays and ``div_grad`` equal the JAX
package's (to 1e-14 of the largest entry: the per-cell sums run in other
orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.apps.euler import initial_state as j_initial_state
from stormx.fvm.bc import far_field_bc as j_far_field_bc
from stormx.fvm.bc import slip_bc as j_slip_bc
from stormx.fvm.divgrad import div_grad as j_div_grad
from stormx.fvm.solver import FvSolver as JFvSolver
from stormx.mesh import build_mesh as j_build_mesh
from stormx.mesh import structured_tri_rect as j_tri_rect
from stormx_torch.apps.euler import initial_state
from stormx_torch.core.exceptions import StormError
from stormx_torch.fvm.bc import far_field_bc, slip_bc
from stormx_torch.fvm.divgrad import div_grad
from stormx_torch.fvm.solver import FvSolver
from stormx_torch.mesh import build_mesh, structured_tri_rect

NODES = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
CELLS = np.array([[0, 1, 2], [0, 2, 3]])
FACE_FIELDS = ("face_nodes", "face_cells", "face_labels", "face_areas", "face_normals",
               "face_centers", "face_label_ranges")


@pytest.fixture
def two_tris():
    return build_mesh(NODES, CELLS), j_build_mesh(NODES, CELLS)


def _assert_same_faces(t, j):
    for name in FACE_FIELDS:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_find_face_and_cell(two_tris):
    m, jm = two_tris
    diag = int(m.interior_faces()[0])
    assert m.find_face([2, 0]) == diag == jm.find_face([2, 0])
    assert m.find_face((0, 2)) == diag
    assert m.find_cell([3, 2, 0]) == 1 == jm.find_cell([3, 2, 0])
    assert m.find_face([0, 9]) is None and jm.find_face([0, 9]) is None
    assert m.find_cell([0, 1, 3]) is None


def test_find_on_a_larger_mesh():
    m, jm = structured_tri_rect(9, 7), j_tri_rect(9, 7)
    rng = np.random.default_rng(0)
    for f in rng.choice(m.num_faces, 40, replace=False):
        nodes = m.face_nodes[f][::-1]
        assert m.find_face(nodes) == jm.find_face(nodes) == f
    for c in rng.choice(m.num_cells, 40, replace=False):
        nodes = np.roll(m.cell_nodes[c], 1)
        assert m.find_cell(nodes) == jm.find_cell(nodes) == c


def test_assign_face_labels(two_tris):
    m, jm = two_tris
    labels = m.face_labels.copy()
    labels[m.find_face([0, 1])] = 2
    m2, jm2 = m.assign_face_labels(labels), jm.assign_face_labels(labels)
    _assert_same_faces(m2, jm2)
    assert m2.num_labels == 3
    assert m2.num_faces_with_label(2) == 1 == jm2.num_faces_with_label(2)
    assert m2.num_faces_with_label(1) == jm2.num_faces_with_label(1) == 3
    f = m2.boundary_faces(2)[0]
    assert set(m2.face_nodes[f].tolist()) == {0, 1}
    np.testing.assert_allclose(m2.face_areas[f], 1.0)
    assert len(m2.interior_faces()) == 1
    # The relabeled mesh drives the FVM path (ghosts per label).
    u = initial_state(m2.num_cells, dtype=torch.float64, device="cpu")
    u2 = FvSolver(m2.device_arrays(torch.float64, device="cpu"), order=1,
                  bcs={1: far_field_bc, 2: slip_bc}).step(u, 1e-3)
    ju2 = JFvSolver(jm2.device_arrays(), order=1,
                    bcs={1: j_far_field_bc, 2: j_slip_bc}).step(j_initial_state(jm2.num_cells),
                                                                1e-3)
    assert torch.isfinite(u2).all()
    np.testing.assert_allclose(u2.numpy(), np.asarray(ju2), rtol=1e-14, atol=1e-14)


def test_lookup_tables_are_not_carried_into_the_new_mesh():
    """The new mesh's faces are in another order, so it builds its own
    lookup tables rather than keeping the old mesh's."""
    m = structured_tri_rect(6, 5)
    labels = m.face_labels.copy()
    bottom = np.nonzero(np.isclose(m.face_centers[:, 1], 0.0))[0]
    labels[bottom] = 2
    some = m.face_nodes[bottom[0]]
    assert m.find_face(some) == bottom[0] and m.find_cell(m.cell_nodes[3]) == 3
    m2 = m.assign_face_labels(labels)
    assert not hasattr(m2, "_face_lut") and not hasattr(m2, "_cell_lut")
    f2 = m2.find_face(some)
    assert f2 != bottom[0] and set(m2.face_nodes[f2]) == set(some)
    assert m2.face_labels[f2] == 2


def test_validation(two_tris):
    m, _ = two_tris
    labels = m.face_labels.copy()
    labels[int(m.interior_faces()[0])] = 1
    with pytest.raises(StormError, match="interior"):
        m.assign_face_labels(labels)
    with pytest.raises(StormError, match="one label per face"):
        m.assign_face_labels(labels[:-1])
    labels = m.face_labels.copy()
    labels[int(m.boundary_faces()[0])] = 0
    with pytest.raises(StormError, match="boundary"):
        m.assign_face_labels(labels)


@pytest.mark.parametrize("banded", [False, True])
def test_relabeled_mesh_device_arrays_and_div_grad(banded):
    """Four boundary labels on a structured mesh: the face arrays, the device
    arrays and div_grad agree with the JAX package's."""
    m, jm = structured_tri_rect(10, 8), j_tri_rect(10, 8)
    fc = m.face_centers
    labels = m.face_labels.copy()
    b = m.boundary_faces()
    labels[b] = np.select([np.isclose(fc[b, 1], 0.0), np.isclose(fc[b, 0], 1.0),
                           np.isclose(fc[b, 1], 1.0)], [1, 2, 3], 4)
    m2, jm2 = m.assign_face_labels(labels), jm.assign_face_labels(labels)
    _assert_same_faces(m2, jm2)
    assert [m2.num_faces_with_label(L) for L in range(5)] == \
        [jm2.num_faces_with_label(L) for L in range(5)]
    td = m2.device_arrays(torch.float64, device="cpu", banded_gather=banded)
    jd = jm2.device_arrays(jnp.float64, banded_gather=banded)
    for name in ("face_inner", "face_outer", "interior_faces", "boundary_faces",
                 "cell_face_ell", "cell_adj_ell"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    assert td.face_label_ranges == tuple(int(x) for x in jd.face_label_ranges)
    x = np.random.default_rng(1).standard_normal(m.num_cells)
    got = div_grad(td, torch.as_tensor(x), 0.1, torch.as_tensor(x)).numpy()
    want = np.asarray(j_div_grad(jd, jnp.asarray(x), 0.1, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(want).max())
