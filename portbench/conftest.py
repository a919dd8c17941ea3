"""pytest settings of the benchmark's tests: the ``card`` marker for tests
that need a CUDA card. Each such test asks for the ``card`` fixture, which
decides while the test runs (never at import or collection) and skips
without a card."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
