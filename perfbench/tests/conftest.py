"""The benchmark's tests: CPU tests of the harness at tiny widths, and
tests marked ``card``, which need an NVIDIA card and skip without one
(``python -m pytest perfbench/tests -m card`` on the card)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)
