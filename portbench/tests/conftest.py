"""pytest settings of the benchmark's own tests: the checkout's root on
sys.path (the harness is the ``portbench`` package), the ``cuda`` marker,
and the ``card`` fixture that skips a test where no CUDA device is found."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (a kernel with no CPU mode); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run on the card")
    return "cuda"
