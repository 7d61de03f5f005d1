"""pytest settings of the benchmark's own tests (``pytest portbench``):
the ``card`` marker for tests that need a CUDA device, and the fixture
that decides, when such a test runs, whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest portbench -m card` on the card")
    return torch.device("cuda")
