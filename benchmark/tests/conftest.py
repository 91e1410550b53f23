"""The benchmark's tests: CPU tests at a tiny size, and tests marked
``cuda`` that need the card and skip without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    from benchmark.tests.tiny import make_tiny_root
    return make_tiny_root(str(tmp_path / "checkout"))
