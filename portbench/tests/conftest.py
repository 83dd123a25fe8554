"""Settings of the benchmark's own tests (``python -m pytest
portbench/tests``).  Tests that need the card take the ``cuda_device``
fixture, which skips where ``torch.cuda.is_available()`` is false; the
decision is made when the test runs, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
