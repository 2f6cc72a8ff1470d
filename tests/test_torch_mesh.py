"""The port's host mesh (build_mesh, structured_tri_rect, read_tetgen,
permute, optimize_ordering) field-equal to the JAX package's, and
device_arrays' tables equal, plans included."""

import dataclasses

import numpy as np
import pytest
import torch

from stormx.mesh import build_hybrid_mesh as j_build_hybrid_mesh
from stormx.mesh import build_mesh as j_build_mesh
from stormx.mesh import read_tetgen as j_read_tetgen
from stormx.mesh import shapes as j_shapes
from stormx.mesh.structured import structured_tet_box as j_tet_box
from stormx.mesh.structured import structured_tri_rect as j_rect
from stormx_torch import interop
from stormx_torch.mesh import build_hybrid_mesh, build_mesh, read_tetgen, structured_tri_rect

MESH_FIELDS = [f.name for f in dataclasses.fields(j_rect(1, 1))]


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_mesh_equal(tm, jm):
    for name in MESH_FIELDS:
        a, b = getattr(tm, name), getattr(jm, name)
        if b is None or isinstance(b, (int, np.integer)):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _delaunay(builder, n, seed):
    from scipy.spatial import Delaunay

    pts = np.random.default_rng(seed).random((n, 2))
    return builder(pts, Delaunay(pts).simplices)


class TestBuild:
    def test_structured_tri_rect(self):
        _assert_mesh_equal(structured_tri_rect(9, 7, lengths=(2.0, 1.5)),
                           j_rect(9, 7, lengths=(2.0, 1.5)))

    def test_delaunay_with_inverted_cells(self):
        _assert_mesh_equal(_delaunay(build_mesh, 400, 1), _delaunay(j_build_mesh, 400, 1))

    def test_tet_box_3d(self):
        jm = j_tet_box(3, 2, 2)
        _assert_mesh_equal(build_mesh(jm.node_positions, jm.cell_nodes), jm)

    def test_hybrid_tri_quad(self):
        nodes = np.array([[0, 0], [1, 0], [2, 0], [0, 1], [1, 1], [2, 1.2]], float)
        groups = [(np.array([[0, 1, 4, 3]]), j_shapes.QUADRANGLE),
                  (np.array([[1, 2, 5], [1, 5, 4]]), j_shapes.TRIANGLE)]
        _assert_mesh_equal(build_hybrid_mesh(nodes, groups), j_build_hybrid_mesh(nodes, groups))

    def test_interop_carries_a_mesh(self):
        jm = j_rect(5, 4)
        fields = {f: getattr(jm, f) for f in MESH_FIELDS}
        _assert_mesh_equal(interop.mesh_from_fields(fields), jm)


def _write_tetgen(prefix, mesh, one_based):
    base = 1 if one_based else 0
    with open(prefix + "node", "w") as f:
        f.write(f"# generated\n{mesh.num_nodes} 2 0 1\n")
        for i, (x, y) in enumerate(mesh.node_positions):
            f.write(f"{i + base} {float(x)!r} {float(y)!r} {i % 3}\n")
    with open(prefix + "ele", "w") as f:
        f.write(f"{mesh.num_cells} 3 0\n")
        for i, (a, b, c) in enumerate(mesh.cell_nodes):
            f.write(f"{i + base} {a + base} {b + base} {c + base}  # cell\n")
    bnd = mesh.boundary_faces()
    with open(prefix + "edge", "w") as f:
        f.write(f"{len(bnd)} 1\n")
        for i, fc in enumerate(bnd):
            a, b = mesh.face_nodes[fc]
            f.write(f"{i + base} {a + base} {b + base} {2 + i % 3}\n")


@pytest.mark.parametrize("one_based", [False, True])
def test_read_tetgen_field_equal(tmp_path, one_based):
    prefix = str(tmp_path / "box.1.")
    _write_tetgen(prefix, j_rect(6, 5), one_based)
    tm, jm = read_tetgen(prefix), j_read_tetgen(prefix)
    _assert_mesh_equal(tm, jm)
    assert tm.num_labels == jm.num_labels >= 3


def test_read_tetgen_missing_file(tmp_path):
    from stormx_torch.core import StormIoError

    with pytest.raises(StormIoError):
        read_tetgen(str(tmp_path / "absent.1."))


class TestOrdering:
    @pytest.mark.parametrize("kind", ["rect", "delaunay"])
    def test_optimize_ordering_identical(self, kind):
        if kind == "rect":
            tm, jm = structured_tri_rect(16, 12), j_rect(16, 12)
        else:
            tm, jm = _delaunay(build_mesh, 600, 2), _delaunay(j_build_mesh, 600, 2)
        _assert_mesh_equal(tm.optimize_ordering(), jm.optimize_for_tpu())

    @pytest.mark.parametrize("rank", ["node", "cell", "face", "edge"])
    def test_permute_identical(self, rank):
        tm, jm = structured_tri_rect(5, 4), j_rect(5, 4)
        n = {"node": tm.num_nodes, "cell": tm.num_cells}.get(rank, tm.num_faces)
        perm = np.random.default_rng(0).permutation(n)
        if rank in ("face", "edge"):  # label-stable: shuffle within labels only
            r = tm.face_label_ranges
            perm = np.concatenate([np.random.default_rng(L).permutation(np.arange(r[L], r[L + 1]))
                                   for L in range(len(r) - 1)])
        _assert_mesh_equal(tm.permute(rank, perm), jm.permute(rank, perm))

    def test_permute_rejects_non_permutations(self):
        from stormx_torch.core import StormError

        tm = structured_tri_rect(3, 3)
        with pytest.raises(StormError):
            tm.permute("cell", np.zeros(tm.num_cells, dtype=int))


DM_TENSORS = ("face_inner", "face_outer", "interior_faces", "boundary_faces", "cell_volumes",
              "cell_centers", "face_areas", "face_normals", "face_centers", "cell_face_ell",
              "cell_face_sign", "cell_adj_ell", "face_dist")
PLANS = ("bg_face_inner", "bg_face_outer", "bg_cell_face", "bg_cell_adj")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_arrays_tables_equal(dtype):
    tm = structured_tri_rect(20, 14).optimize_ordering()
    jm = j_rect(20, 14).optimize_for_tpu()
    jd = jm.device_arrays(dtype=np.float64 if dtype == torch.float64 else np.float32,
                          banded_gather=True)
    td = tm.device_arrays(dtype=dtype, device="cpu", banded_gather=True)
    for name in ("dim", "num_cells", "num_faces", "face_label_ranges"):
        assert getattr(td, name) == getattr(jd, name), name
    for name in DM_TENSORS:
        a, b = _np(getattr(td, name)), np.asarray(getattr(jd, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in PLANS:
        tp, jp = getattr(td, name), getattr(jd, name)
        assert (tp.window, tp.m, tp.n_src, tp.xla_fallback) == (jp.window, jp.m, jp.n_src,
                                                                 jp.xla_fallback)
        for f in ("starts", "lidx", "fix_pos", "fix_idx"):
            np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)))


def test_device_arrays_builds_plans_only_for_cuda_f32():
    tm = structured_tri_rect(4, 4)
    assert tm.device_arrays(dtype=torch.float32, device="cpu").bg_face_inner is None
    assert tm.device_arrays(dtype=torch.float64, device="cpu").bg_cell_adj is None
