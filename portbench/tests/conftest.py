"""The benchmark's own tests: `python -m pytest portbench/tests`.

Tests that need a CUDA card carry the `chip` marker and take the
`cuda_device` fixture, which decides (at run time, never at import)
whether there is one and skips the test here when there is not.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    return torch.device("cuda", 0)
