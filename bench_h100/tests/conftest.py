"""The benchmark's tests: on the CPU at small sizes, and (marked
``card``) on a CUDA device at the cells' own sizes."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (HERE, os.path.dirname(os.path.dirname(HERE))):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cells run on an H100)")
    return "cuda"
