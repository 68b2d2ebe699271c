"""Tests of the benchmark: `python -m pytest -q gpubench/tests` from the
root of the repository (the repository's own `pytest tests/` does not
collect them).  Tests marked `card` need a CUDA card and skip without
one; the decision is made inside the `card` fixture, not at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card tests run only on one")
    return torch.device("cuda", 0)
