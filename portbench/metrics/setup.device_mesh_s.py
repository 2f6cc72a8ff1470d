"""Host set-up of the device mesh (``UnstructuredMesh.device_arrays``: K3's
banded-gather plans and the uploads): host seconds of the program's
``mesh.device`` span."""

from portbench.program_spans import setup_seconds


def read(run):
    return setup_seconds(run, "mesh.device")
