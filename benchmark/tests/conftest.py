"""Shared fixtures of the benchmark's own tests.

    python -m pytest -q -p no:cacheprovider benchmark/tests      (CPU; card tests skip)

Tests marked `card` need a CUDA card and skip without one; the harness's
chip runs use them: python -m pytest -q -p no:cacheprovider -m card benchmark/tests
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
