"""pytest settings of the benchmark's own tests (``python -m pytest
slambench``): the ``card`` marker, and a fixture that skips a test when this
machine has no CUDA card. The check is made when a test asks for the
fixture, never when a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda"
