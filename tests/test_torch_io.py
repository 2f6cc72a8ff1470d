"""``stormx_torch.io`` and the Cahn–Hilliard ``run``/``main`` side channels
against the JAX package's, on the CPU.

VTK files are byte-identical to the JAX writer's for the same mesh and
field.  Checkpoints written by either package load in the other with
bit-equal leaves (both flatten dict keys sorted, as ``jax.tree_util``
does).  The CH runs agree to 1e-10 in float64 (the CG solves sum in other
orders); the port's snapshots are byte-identical to the JAX writer's on the
port's field, and a resumed run is bit-equal to the uninterrupted one.
"""

import collections
import inspect
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.io as J
import stormx_torch.io as T
from stormx.apps import cahn_hilliard as j_ch
from stormx.mesh import build_hybrid_mesh as j_build_hybrid_mesh
from stormx.mesh import shapes as j_shapes
from stormx.mesh import structured_tet_box as j_tet_box
from stormx.mesh import structured_tri_rect as j_tri_rect
from stormx_torch.apps import cahn_hilliard as t_ch
from stormx_torch.core.exceptions import StormError
from stormx_torch.mesh import build_hybrid_mesh, shapes, structured_tet_box, structured_tri_rect
from stormx_torch.solvers import SolverOptions

HYBRID_2D = (
    np.array([[0, 0], [1, 0], [2, 0], [0, 1], [1, 1], [2, 1]], dtype=float),
    [(np.array([[0, 1, 3], [1, 4, 3]]), "TRIANGLE"), (np.array([[1, 2, 5, 4]]), "QUADRANGLE")],
)
HYBRID_3D = (
    np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1],
              [1, 1, 1], [2, 0, 0], [2, 1, 0]], dtype=float),
    [(np.array([[0, 1, 2, 3]]), "TETRAHEDRON"), (np.array([[1, 4, 2, 0, 3]]), "PYRAMID"),
     (np.array([[1, 8, 4, 5, 9, 7]]), "PENTAHEDRON")],
)


def _mesh_pair(kind):
    if kind == "tri":
        return structured_tri_rect(7, 5), j_tri_rect(7, 5)
    if kind == "tet":
        return structured_tet_box(3, 3, 2), j_tet_box(3, 3, 2)
    nodes, groups = HYBRID_2D if kind == "hybrid2d" else HYBRID_3D
    return (build_hybrid_mesh(nodes, [(c, getattr(shapes, s)) for c, s in groups]),
            j_build_hybrid_mesh(nodes, [(c, getattr(j_shapes, s)) for c, s in groups]))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# -- VTK ------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["tri", "tet", "hybrid2d", "hybrid3d"])
def test_vtk_byte_identical(tmp_path, kind):
    tm, jm = _mesh_pair(kind)
    rng = np.random.default_rng(0)
    c = rng.standard_normal(tm.num_cells)
    u = rng.standard_normal((tm.num_cells, 3))
    T.write_vtk(tm, str(tmp_path / "t.vtk"), {"c": torch.as_tensor(c), "u": torch.as_tensor(u)})
    J.write_vtk(jm, str(tmp_path / "j.vtk"), {"c": jnp.asarray(c), "u": jnp.asarray(u)})
    assert _read(tmp_path / "t.vtk") == _read(tmp_path / "j.vtk")
    T.write_vtk(tm, str(tmp_path / "t0.vtk"))
    J.write_vtk(jm, str(tmp_path / "j0.vtk"))
    assert _read(tmp_path / "t0.vtk") == _read(tmp_path / "j0.vtk")


def test_vtk_float32_and_numpy_fields(tmp_path):
    tm, jm = _mesh_pair("tri")
    c = np.random.default_rng(1).standard_normal(tm.num_cells).astype(np.float32)
    T.write_vtk(tm, str(tmp_path / "t.vtk"), {"c": torch.as_tensor(c), "d": c})
    J.write_vtk(jm, str(tmp_path / "j.vtk"), {"c": jnp.asarray(c), "d": c})
    assert _read(tmp_path / "t.vtk") == _read(tmp_path / "j.vtk")


def test_vtk_header_counts(tmp_path):
    tm, _ = _mesh_pair("hybrid3d")
    T.write_vtk(tm, str(tmp_path / "h.vtk"), {"c": torch.zeros(tm.num_cells)})
    lines = open(tmp_path / "h.vtk").read().splitlines()
    assert f"POINTS {tm.num_nodes} double" in lines
    ti = lines.index("CELL_TYPES 3")
    assert lines[ti + 1: ti + 4] == ["10", "14", "13"]
    assert "CELLS 3 18" in lines and "CELL_DATA 3" in lines


# -- checkpoints -------------------------------------------------------------------
NT = collections.namedtuple("NT", "x y")


def _state(lib):
    rng = np.random.default_rng(2)
    c = rng.standard_normal(12)
    m = rng.integers(0, 9, (3, 2)).astype(np.int32)
    if lib == "torch":
        return {"step": 7, "c": torch.as_tensor(c),
                "nested": {"z": [torch.as_tensor(m), (1.5,)], "a": None, "nt": NT(3, c[:2])}}
    return {"step": 7, "c": jnp.asarray(c),
            "nested": {"z": [jnp.asarray(m), (1.5,)], "a": None, "nt": NT(3, c[:2])}}


def _assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def test_checkpoints_cross_load(tmp_path):
    tp = T.save_checkpoint(str(tmp_path / "t"), 7, _state("torch"))
    jp = J.save_checkpoint(str(tmp_path / "j"), 7, _state("jax"))
    with open(os.path.join(tp, "stormx_meta.json")) as f:
        tmeta = json.load(f)
    with open(os.path.join(jp, "stormx_meta.json")) as f:
        jmeta = json.load(f)
    assert os.path.basename(tp) == os.path.basename(jp) == "step_0000000007"
    assert tmeta["treedef"] == jmeta["treedef"] and tmeta["num_leaves"] == jmeta["num_leaves"]
    assert tmeta["layout"]["num_parts"] is None
    t_leaves, t_step = T.load_checkpoint(str(tmp_path / "t"))
    j_leaves, j_step = J.load_checkpoint(str(tmp_path / "j"))
    assert t_step == j_step == 7
    _assert_leaves_equal(t_leaves, j_leaves)
    # Each package reads the other's.
    _assert_leaves_equal(T.load_checkpoint(str(tmp_path / "j"))[0], j_leaves)
    _assert_leaves_equal(J.load_checkpoint(str(tmp_path / "t"))[0], t_leaves)
    assert all(isinstance(leaf, np.ndarray) for leaf in t_leaves)


def test_unsorted_dict_keys_restore_into_like(tmp_path):
    """{"step", "c"}: insertion order differs from JAX's sorted order; the
    leaves are stored sorted and restored by key."""
    c = torch.arange(5.0, dtype=torch.float64)
    T.save_checkpoint(str(tmp_path), 3, {"step": 3, "c": c})
    leaves, _ = T.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(leaves[0], c.numpy())
    assert int(leaves[1]) == 3
    tree, step = T.load_checkpoint(str(tmp_path), like={"step": 0, "c": c})
    assert list(tree) == ["step", "c"] and int(tree["step"]) == 3 and step == 3
    np.testing.assert_array_equal(tree["c"], c.numpy())
    jtree, _ = J.load_checkpoint(str(tmp_path), like={"step": 0, "c": jnp.asarray(c)})
    np.testing.assert_array_equal(np.asarray(jtree["c"]), c.numpy())
    like = _state("torch")
    T.save_checkpoint(str(tmp_path / "n"), 1, like)
    tree, _ = T.load_checkpoint(str(tmp_path / "n"), like=like)
    assert isinstance(tree["nested"]["nt"], NT) and tree["nested"]["a"] is None
    assert tree["nested"]["z"][1][0] == 1.5


def test_latest_step_and_pruning(tmp_path):
    d = str(tmp_path / "ck")
    assert T.latest_step(d) is None
    ck = T.Checkpointer(d, every=2, keep=2)
    saved = [ck.maybe_save(k, {"c": torch.tensor([float(k)])}) for k in range(1, 9)]
    assert [s is not None for s in saved] == [k % 2 == 0 for k in range(1, 9)]
    assert T.latest_step(d) == J.latest_step(d) == 8
    assert sorted(os.listdir(d)) == ["step_0000000006", "step_0000000008"]
    tree, step = ck.restore(like={"c": torch.zeros(1)})
    assert step == 8 and float(tree["c"][0]) == 8.0
    with pytest.raises(FileNotFoundError):
        T.load_checkpoint(str(tmp_path / "none"))


def test_layout_mismatch(tmp_path):
    T.save_checkpoint(str(tmp_path), 1, {"c": torch.zeros(2)}, num_parts=4)
    with pytest.raises(ValueError, match="num_parts=4"):
        T.load_checkpoint(str(tmp_path), num_parts=2)
    assert T.load_checkpoint(str(tmp_path), num_parts=4)[1] == 1
    with pytest.raises(ValueError, match="num_parts=4"):
        J.load_checkpoint(str(tmp_path), num_parts=2)


def test_orbax_backend_is_refused(tmp_path):
    with pytest.raises(StormError, match="orbax"):
        T.save_checkpoint(str(tmp_path), 1, {"c": torch.zeros(2)}, backend="orbax")
    with pytest.raises(StormError, match="orbax"):
        T.Checkpointer(str(tmp_path), backend="orbax")
    with pytest.raises(ValueError):
        T.save_checkpoint(str(tmp_path), 1, {"c": torch.zeros(2)}, backend="hdf5")
    # An orbax checkpoint of the JAX package is named, not misread.
    path = tmp_path / "o" / "step_0000000001"
    path.mkdir(parents=True)
    (path / "stormx_meta.json").write_text(json.dumps(
        {"step": 1, "treedef": "PyTreeDef(*)", "num_leaves": 1,
         "layout": {"num_parts": None, "num_devices": 1}, "backend": "orbax"}))
    with pytest.raises(StormError, match="orbax"):
        T.load_checkpoint(str(tmp_path / "o"))


# -- viz ----------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["tri", "tet", "hybrid2d"])
def test_viz_writes_pngs(tmp_path, kind):
    tm, _ = _mesh_pair(kind)
    field = torch.as_tensor(np.random.default_rng(3).standard_normal(tm.num_cells))
    T.visualize_mesh(tm, str(tmp_path / "mesh.png"))
    T.plot_cell_field(tm, field, str(tmp_path / "field.png"), title="c")
    T.plot_convergence({"cg": torch.tensor([1.0, 0.1, 0.01, float("nan")]),
                        "np": np.array([1.0, 0.5, 0.0])}, str(tmp_path / "conv.png"))
    for name in ("mesh.png", "field.png", "conv.png"):
        assert os.path.getsize(tmp_path / name) > 1000


def test_viz_without_matplotlib_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tm, _ = _mesh_pair("tri")
    for call in (lambda: T.visualize_mesh(tm), lambda: T.plot_convergence({}),
                 lambda: T.plot_cell_field(tm, np.zeros(tm.num_cells))):
        with pytest.raises(StormError, match="matplotlib"):
            call()


# -- the Cahn–Hilliard side channels --------------------------------------------------
CH_OPTS = dict(num_iterations=2000, absolute_tolerance=0.0, relative_tolerance=1e-12)


@pytest.fixture(scope="module")
def ch_meshes():
    return structured_tri_rect(12, 10), j_tri_rect(12, 10)


def _c0(n):
    return 0.5 + 0.1 * np.random.default_rng(0).standard_normal(n)


def _split_vtk(data: bytes):
    head, _, values = data.partition(b"CELL_DATA")
    return head, np.array(values.split(b"\n")[3:-2], dtype=float)


def test_run_side_channels_match_jax(tmp_path, ch_meshes):
    tm, jm = ch_meshes
    td = tm.device_arrays(torch.float64, device="cpu")
    jd = jm.device_arrays()
    c0 = _c0(tm.num_cells)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    c = t_ch.run(td, torch.as_tensor(c0), 4, mesh=tm, output_every=2,
                 output_dir=str(tmp_path / "t"),
                 checkpointer=T.Checkpointer(str(tmp_path / "t" / "ck"), every=2),
                 options=SolverOptions(**CH_OPTS), device="cpu")
    from stormx.solvers import SolverOptions as JOptions

    cj = j_ch.run(jd, jnp.asarray(c0), 4, mesh=jm, output_every=2,
                  output_dir=str(tmp_path / "j"),
                  checkpointer=J.Checkpointer(str(tmp_path / "j" / "ck"), every=2),
                  options=JOptions(**CH_OPTS))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0, atol=1e-10)
    for k in (2, 4):
        name = f"out_cahn_hilliard_{k}.vtk"
        t_bytes, j_bytes = _read(tmp_path / "t" / name), _read(tmp_path / "j" / name)
        (t_head, t_vals), (j_head, j_vals) = _split_vtk(t_bytes), _split_vtk(j_bytes)
        assert t_head == j_head and len(t_vals) == tm.num_cells
        np.testing.assert_allclose(t_vals, j_vals, rtol=0, atol=1e-10)
    # Where the fields are equal, the files are: the JAX writer on the
    # port's last field gives the port's last snapshot.
    J.write_vtk(jm, str(tmp_path / "jc.vtk"), {"c": c.numpy()})
    assert _read(tmp_path / "jc.vtk") == _read(tmp_path / "t" / "out_cahn_hilliard_4.vtk")
    assert sorted(os.listdir(tmp_path / "t" / "ck")) == sorted(os.listdir(tmp_path / "j" / "ck"))
    (t_c, t_step), _ = T.load_checkpoint(str(tmp_path / "t" / "ck"))
    (j_c, j_step), _ = J.load_checkpoint(str(tmp_path / "j" / "ck"))
    assert int(t_step) == int(j_step) == 4
    np.testing.assert_array_equal(t_c, c.numpy())
    # JAX reads the port's checkpoint with the same leaves.
    (c_read, _), step = J.load_checkpoint(str(tmp_path / "t" / "ck"))
    assert step == 4 and c_read.tobytes() == c.numpy().tobytes()


@pytest.mark.parametrize("assembled", [False, True])
def test_resume_is_bit_equal(tmp_path, ch_meshes, assembled):
    tm, _ = ch_meshes
    td = tm.device_arrays(torch.float64, device="cpu")
    c0 = torch.as_tensor(_c0(tm.num_cells))
    kw = dict(mesh=tm, assembled=assembled, options=SolverOptions(**CH_OPTS), device="cpu",
              **({"dtype": torch.float64} if assembled else {}))
    full = t_ch.run(td, c0, 4, checkpointer=T.Checkpointer(str(tmp_path / "a"), every=2), **kw)
    (c2, step2), _ = T.load_checkpoint(str(tmp_path / "a"), 2)
    assert int(step2) == 2
    resumed = t_ch.run(td, torch.as_tensor(c2), 2, start_step=2,
                       checkpointer=T.Checkpointer(str(tmp_path / "b"), every=2), **kw)
    assert torch.equal(resumed, full)
    assert T.latest_step(str(tmp_path / "b")) == 4
    _assert_leaves_equal(T.load_checkpoint(str(tmp_path / "a"), 4)[0],
                         T.load_checkpoint(str(tmp_path / "b"), 4)[0])


def test_no_side_channel_is_refused():
    assert "NotImplementedError" not in inspect.getsource(t_ch)


def _write_tetgen(prefix, mesh):
    ids = np.arange(mesh.num_nodes)
    np.savetxt(prefix + "node", np.column_stack([ids, mesh.node_positions]),
               fmt=["%d", "%.17g", "%.17g"], header=f"{mesh.num_nodes} 2 0 0", comments="")
    np.savetxt(prefix + "ele", np.column_stack([np.arange(mesh.num_cells), mesh.cell_nodes]),
               fmt="%d", header=f"{mesh.num_cells} 3 0", comments="")


def test_main_writes_ten_snapshots(tmp_path, monkeypatch, capsys, ch_meshes):
    tm, _ = ch_meshes
    prefix = str(tmp_path / "mesh.1.")
    _write_tetgen(prefix, tm)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    c = t_ch.main(prefix, num_steps=10, device="cpu")
    assert "sparse linear algebra" in capsys.readouterr().out
    names = sorted(os.listdir(run_dir), key=lambda s: int(s.split("_")[-1][:-4]))
    assert names == [f"out_cahn_hilliard_{k}.vtk" for k in range(1, 11)]
    assert c.dtype == torch.float32 and torch.isfinite(c).all()
    head, vals = _split_vtk(_read(run_dir / names[-1]))
    assert f"CELLS {tm.num_cells} ".encode() in head
    np.testing.assert_array_equal(vals.astype(np.float32), c.numpy())
