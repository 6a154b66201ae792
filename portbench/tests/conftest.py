"""The benchmark's own tests: CPU cases, and card cases marked ``cuda``.

Run from the checkout's root: ``python -m pytest portbench/tests -q``; on the
card ``python -m pytest portbench/tests -m cuda -q``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); "
        "skips where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's CUDA kernels at its own size")
    return torch.device("cuda", 0)
