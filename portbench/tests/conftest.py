"""The harness's CPU tests (``python -m pytest portbench/tests``).  Tests
marked ``cuda`` need a card: each decides inside itself whether there is
one and skips on the CPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the small cells of ``tiny.py`` added."""
    from portbench.tests.tiny import add_tiny_cells, copy_bench

    return add_tiny_cells(copy_bench(str(tmp_path / "checkout")))
