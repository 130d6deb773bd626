"""Tests of the benchmark harness (run with ``python -m pytest
benchmark/tests`` from the repository's root).  Cases that need a CUDA
card carry the ``card`` marker and take the ``card`` fixture, which skips
them where no card is visible."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)
