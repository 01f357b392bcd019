"""The benchmark's own tests.  ``card``: a test that needs a CUDA card
(decided inside the test by the ``card`` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                                       "without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' program runs there only")
