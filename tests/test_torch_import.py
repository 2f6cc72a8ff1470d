"""stormx_torch stands alone: importing it loads neither JAX nor the JAX
package, no source file of it imports them, and its entry points refuse to
drift to the CPU when no GPU is present."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "stormx_torch")

IMPORT_ALL = """
import importlib, os, sys
import stormx_torch
root = os.path.dirname(os.path.dirname(stormx_torch.__file__))
for d, _, files in os.walk(os.path.dirname(stormx_torch.__file__)):
    for f in files:
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(d, f), root)[:-3].replace(os.sep, ".")
            importlib.import_module(rel.removesuffix(".__init__"))
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k == "stormx" or k.startswith("stormx.")]
assert not bad, bad
print(len([k for k in sys.modules if k.startswith("stormx_torch")]))
"""


def test_fresh_import_loads_no_jax_and_no_stormx():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every submodule was imported


FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import stormx\.|from stormx\.|from stormx import|import stormx\s*$)",
    re.M,
)


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither_jax_nor_stormx(path):
    with open(path) as f:
        text = f.read()
    assert not FORBIDDEN.search(text), path


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from stormx_torch.apps.cahn_hilliard import main, make_assembled_step, make_step, run
    from stormx_torch.core import StormError
    from stormx_torch.mesh import structured_tri_rect

    mesh = structured_tri_rect(4, 3)
    with pytest.raises(StormError):
        mesh.device_arrays()
    with pytest.raises(StormError):
        make_assembled_step(mesh)
    dmesh = mesh.device_arrays(dtype=torch.float64, device="cpu")
    with pytest.raises(StormError):
        make_step(dmesh)
    c0 = torch.full((mesh.num_cells,), 0.5, dtype=torch.float64)
    with pytest.raises(StormError):
        run(dmesh, c0, 1)
    with pytest.raises(StormError):
        run(dmesh, c0, 1, mesh=mesh, assembled=True)
    prefix = str(tmp_path / "m.1.")
    _write_tetgen(prefix, mesh)
    with pytest.raises(StormError):
        main(prefix, num_steps=1)


def test_entry_points_run_on_cpu_when_asked(no_gpu, tmp_path, monkeypatch):
    from stormx_torch.apps.cahn_hilliard import main, make_assembled_step, make_step, run
    from stormx_torch.mesh import structured_tri_rect

    mesh = structured_tri_rect(4, 3)
    dmesh = mesh.device_arrays(dtype=torch.float64, device="cpu")
    assert dmesh.device.type == "cpu" and dmesh.bg_face_inner is None
    c0 = torch.full((mesh.num_cells,), 0.5, dtype=torch.float64)
    c0 = c0 + 0.1 * torch.as_tensor(np.random.default_rng(0).standard_normal(mesh.num_cells))
    c1, res = make_step(dmesh, device="cpu")(c0)
    assert res.converged and c1.device.type == "cpu"
    c2, res = make_assembled_step(mesh, dtype=torch.float64, device="cpu")(c0)
    assert res.converged
    assert torch.isfinite(run(dmesh, c0, 2, device="cpu")).all()
    prefix = str(tmp_path / "m.1.")
    _write_tetgen(prefix, mesh)
    monkeypatch.chdir(tmp_path)  # main writes its snapshots into the working directory
    c = main(prefix, num_steps=2, device="cpu")
    assert c.dtype == torch.float32 and torch.isfinite(c).all()
    assert sorted(p.name for p in tmp_path.glob("*.vtk")) == [
        "out_cahn_hilliard_1.vtk", "out_cahn_hilliard_2.vtk"]


def _write_tetgen(prefix, mesh):
    with open(prefix + "node", "w") as f:
        f.write(f"{mesh.num_nodes} 2 0 0\n")
        for i, (x, y) in enumerate(mesh.node_positions):
            f.write(f"{i} {float(x)!r} {float(y)!r}\n")
    with open(prefix + "ele", "w") as f:
        f.write(f"{mesh.num_cells} 3 0\n")
        for i, (a, b, c) in enumerate(mesh.cell_nodes):
            f.write(f"{i} {a} {b} {c}\n")


# The modules of ``stormx/parallel`` that wait for the next slice of the
# distributed layer (ROADMAP.md §1), and the names ``parallel/__init__.py``
# takes from them: none are left.
WAITING = ()
WAITING_NAMES = ()

# Names the port carries under another name, or leaves out by decision.
RENAMED_OR_LATER = {
    ("mesh/unstructured.py", "UnstructuredMesh.optimize_for_tpu"),  # optimize_ordering
    # A TPU v5e's ICI link rate and hop latency, the JAX project_scaling's
    # defaults: the port states no TPU figure, so its project_scaling takes
    # link_bw and latency_s as required arguments.
    ("parallel/commvol.py", "V5E_ICI_LINK_BW"),
    ("parallel/commvol.py", "V5E_ICI_LATENCY_S"),
    # The JAX package's Timer read the host clock with no synchronise (the
    # enqueue, on the card); the port's spans (core/profiling.py) replace it.
    ("core/profiling.py", "Timer"),
    ("core/profiling.py", "Timer.report"),
    ("core/__init__.py", "Timer"),
} | {("parallel/__init__.py", n) for n in WAITING_NAMES}


def _public_names(path):
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")}
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            out |= {e.value for e in node.value.elts}
    return out


def _jax_modules():
    root = os.path.join(REPO, "stormx")
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            if f.endswith(".py") and rel not in WAITING and not f.startswith("pallas_"):
                yield rel


@pytest.mark.parametrize("rel", sorted(_jax_modules()))
def test_public_names_match_the_jax_package(rel):
    """Outside the modules of ``parallel/`` that wait for the next slice
    (``WAITING``) and the Pallas modules (whose kernels the port
    has under its own file names), each JAX module's public functions,
    classes, methods and ``__all__`` names exist in the port's module of
    the same path."""
    want = _public_names(os.path.join(REPO, "stormx", rel))
    port = os.path.join(PKG, rel)
    have = _public_names(port) if os.path.exists(port) else set()
    missing = {n for n in want - have if (rel, n) not in RENAMED_OR_LATER}
    assert not missing, f"{rel}: {sorted(missing)}"


def test_waiting_parallel_modules_are_the_unported_ones():
    """``WAITING`` lists exactly the JAX ``parallel`` modules the port does
    not have yet, so a slice that ports one must take it off the list (and
    the name check above then holds it)."""
    for rel in WAITING:
        assert os.path.exists(os.path.join(REPO, "stormx", rel)), rel
        assert not os.path.exists(os.path.join(PKG, rel)), rel
    import stormx_torch.parallel as tpar

    assert not set(WAITING_NAMES) & set(tpar.__all__)


def test_parallel_exports_are_the_jax_packages():
    """``stormx_torch.parallel`` exports exactly the JAX ``__all__``, and
    ``ShardedNsProjection`` lives in ``parallel/ns.py``, outside it, as in
    the JAX package."""
    import stormx_torch.parallel as tpar
    from stormx_torch.parallel.ns import ShardedNsProjection

    want = _public_names(os.path.join(REPO, "stormx", "parallel", "__init__.py"))
    assert set(tpar.__all__) == want and len(tpar.__all__) == len(want)
    assert all(hasattr(tpar, n) for n in tpar.__all__)
    assert "ShardedNsProjection" not in tpar.__all__ and callable(ShardedNsProjection)


def test_parallel_entry_points_raise_without_gpu(no_gpu):
    """The distributed layer puts its arrays and ranks on the card unless
    the caller asks for the CPU, and raises where there is no card."""
    from stormx_torch import parallel as tpar
    from stormx_torch.core import StormError
    from stormx_torch.parallel.comm import run_thread_ranks
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import structured_tri_rect
    from stormx_torch.sparse.formats import DIA

    csr = assemble_laplacian(structured_tri_rect(6, 5)).to_csr()
    pop = tpar.partition_csr(csr, 2, device="cpu")
    dia = DIA(data=torch.ones(1, 8, dtype=torch.float64), offsets=(0,), shape=(8, 8))
    for call in (lambda: tpar.partition_csr(csr, 2),
                 lambda: tpar.partition_dia(dia, 2),
                 lambda: tpar.partition_sliced(csr, 2),
                 lambda: tpar.DistributedAmg(csr, pop),
                 lambda: run_thread_ranks(2, lambda mesh: None),
                 lambda: tpar.make_device_mesh(2)):
        with pytest.raises(StormError):
            call()
    assert run_thread_ranks(2, lambda mesh: mesh.device.type, device="cpu") == ["cpu"] * 2
