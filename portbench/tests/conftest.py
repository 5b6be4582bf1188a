"""The benchmark's own tests (``python -m pytest portbench/tests``).  Tests
marked ``card`` need a CUDA device and skip without one; whether there is
one is decided in the ``card`` fixture, when a test runs.  The small
graphs of the CPU tests take the path the cells' 35,520-atom graphs take
on the card: the cell-list selection and the spatial sort."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def cells_path(request, monkeypatch):
    """Off the card, the selection and sort thresholds lowered below the
    small graphs' sizes."""
    if "card" in request.fixturenames:
        return
    from epnn_tpu_torch import infer

    monkeypatch.setattr(infer, "CELL_GRID_MIN_ATOMS", 16)
    monkeypatch.setattr(infer, "CELL_SORT_MIN_ATOMS", 16)
