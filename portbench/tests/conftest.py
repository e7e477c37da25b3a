"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root (on the CPU; the ``cuda`` ones run on the card).

Tests that need the card carry the ``cuda`` marker and ask for the
``cuda_device`` fixture, which skips them where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skipped elsewhere)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
