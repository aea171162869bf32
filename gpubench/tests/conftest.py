"""CPU tests of the benchmark (``python -m pytest gpubench/tests``). Tests
that need a CUDA device carry the ``cuda`` marker and skip inside the
``cuda_device`` fixture when there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
