"""Host set-up of the mesh (``mesh/*``: ``build_mesh``,
``optimize_ordering``): host seconds around the calls."""


def read(run):
    return run.setup_times.get("mesh_s")
