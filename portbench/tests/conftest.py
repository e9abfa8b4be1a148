"""The harness's own tests: on the CPU at small sizes, and a few marked
``chip`` that need the card and skip without one."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent  # portbench/
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
